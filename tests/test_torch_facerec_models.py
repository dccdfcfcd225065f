"""The port's face-recognition models against the JAX package's, on the CPU.

``Backbone`` (ir and ir_se) and ``PSpFaceRec`` with a 4-unit body at 32 px
(``tests/test_train_stage3.py``'s TinyBackbone layout), their weights
carried with ``from_jax`` (strict), on the same numpy inputs in f32.
Dropout cannot match JAX's draws: it is off on both sides (JAX: test-local
subclasses with ``Dropout(0.0)`` and no block dropout; the port: p = 0),
and the port's dropout placement and scaling are held on their own.

Tolerances: eval-mode embeddings 1e-4 of the output's scale (convolutions
summed in another order than XLA's, as ``test_torch_models.py``);
train-mode outputs and BatchNorm running statistics 1e-5 of scale; the
single layers (BatchNorm, Flatten -> Linear) 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu import nn as jnn
from stylegan_for_facerec_tpu.losses import identity as jident
from stylegan_for_facerec_tpu.models import irse as jirse
from stylegan_for_facerec_tpu.models import psp as jpsp
from stylegan_for_facerec_torch.losses.identity import (id_loss,
                                                        make_irse_id_extractor)
from stylegan_for_facerec_torch.models import irse, psp
from stylegan_for_facerec_torch.nn.layers import (BatchNorm1d, BatchNorm2d,
                                                  Dropout, Flatten)
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax

UNITS = [(64, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_children(ch, se):
    ch["body"] = jnn.Sequential(*[jirse.BottleneckIR(i, d, s, se=se)
                                  for i, d, s in UNITS])
    layers = list(ch["output_layer"].layers)
    layers[1] = jnn.Dropout(0.0)
    ch["output_layer"] = jnn.Sequential(*layers)
    return ch


class JTinyBackbone(jirse.Backbone):
    def _children(self):
        return _tiny_children(super()._children(), self.mode == "ir_se")


class JTinyEncoder(jpsp.BackboneEncoderDiffHead):
    def _children(self):
        return _tiny_children(super()._children(), True)


class JTinyPSpFaceRec(jpsp.PSpFaceRec):
    def _children(self):
        return {"encoder": JTinyEncoder(self.num_layers, "ir_se",
                                        input_size=self.size,
                                        emb_size=self.emb_size)}


def tiny_port(model, body_owner, se=True, dropout=None):
    """The port model with the 4-unit body and dropout p = 0."""
    body_owner.body = torch.nn.Sequential(*[
        irse.BottleneckIR(i, d, s, se=se, dropout=dropout)
        for i, d, s in UNITS])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def perturbed(layer, seed):
    """JAX (params, state) as numpy with non-trivial BN statistics, biases
    and PReLU slopes."""
    params, state = layer.init(jax.random.key(seed))
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.array(v)
            if k in ("bias", "mean"):
                v = v + 0.1 * rng.randn(*v.shape).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[k] = v
        return out

    return walk(params), walk(state)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def close_scaled(got, want, rel, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} * {scale:.3e}"


def _bn_states(jstate, prefix=""):
    """{torch name of a BN: (mean, var)} from a JAX state tree."""
    out = {}
    for k, v in jstate.items():
        if isinstance(v, dict):
            if "mean" in v and "var" in v:
                out[prefix + k] = (np.asarray(v["mean"]), np.asarray(v["var"]))
            else:
                out.update(_bn_states(v, prefix + k + "."))
    return out


def _check_train_mode(jm, params, state, tm, x, rel_out=1e-5):
    """One train-mode forward on both sides: outputs and every BatchNorm's
    running statistics."""
    want, new_state = jm.apply(params, state, jnp.asarray(x),
                               jnn.Ctx(train=True, rng=jax.random.key(0)))
    tm.train()
    got = tm(nchw(x)).detach().numpy()
    close_scaled(got, want, rel_out, "train-mode output")
    stats = _bn_states(jax.tree_util.tree_map(np.asarray, new_state))
    mods = dict(tm.named_modules())
    assert len(stats) == 14      # every BatchNorm of the tiny network
    for name, (mean, var) in stats.items():
        bn = mods[name]
        close_scaled(bn.running_mean.numpy(), mean, 1e-5, name + " mean")
        close_scaled(bn.running_var.numpy(), var, 1e-5, name + " var")


@pytest.mark.parametrize("mode", ["ir", "ir_se"])
def test_backbone_eval_matches_jax(mode):
    jm = JTinyBackbone(input_size=32, num_layers=50, mode=mode, emb_size=64)
    params, state = perturbed(jm, 1)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    want, _ = jm.apply(params, state, jnp.asarray(x), jnn.Ctx(train=False))
    tm = irse.Backbone(32, 50, mode, emb_size=64)
    tiny_port(tm, tm, se=mode == "ir_se")
    load_from_jax(tm, params, state).eval()
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
        feats = tm.features(nchw(x)).numpy()
    assert got.shape == (2, 64) and feats.shape == (2, 512, 2, 2)
    close_scaled(got, want, 1e-4, "embedding")
    jf, _ = jm.features(params, state, jnp.asarray(x), jnn.Ctx(train=False))
    close_scaled(np.moveaxis(feats, 1, -1), jf, 1e-4, "features")


@pytest.mark.parametrize("mode", ["ir", "ir_se"])
def test_backbone_train_mode_matches_jax(mode):
    jm = JTinyBackbone(input_size=32, num_layers=50, mode=mode, emb_size=64)
    params, state = perturbed(jm, 3)
    x = np.random.RandomState(4).randn(4, 32, 32, 3).astype(np.float32)
    tm = irse.Backbone(32, 50, mode, emb_size=64)
    tiny_port(tm, tm, se=mode == "ir_se")
    load_from_jax(tm, params, state)
    _check_train_mode(jm, params, state, tm, x)


@pytest.fixture(scope="module")
def facerec_pair():
    jm = JTinyPSpFaceRec(size=32, emb_size=64)
    params, state = perturbed(jm, 5)
    state["avg_image"] = np.random.RandomState(6).uniform(
        -1, 1, (32, 32, 3)).astype(np.float32)
    return jm, params, state


def _port_facerec(params, state):
    tm = psp.PSpFaceRec(size=32, emb_size=64)
    tiny_port(tm, tm.encoder)
    return load_from_jax(tm, params, state)


def test_psp_facerec_eval_matches_jax(facerec_pair):
    jm, params, state = facerec_pair
    tm = _port_facerec(params, state).eval()
    np.testing.assert_array_equal(tm.avg_image.permute(1, 2, 0).numpy(),
                                  state["avg_image"])
    rng = np.random.RandomState(7)
    # 32 px as the model's size, 40 px through the bilinear resize
    for size in (32, 40):
        x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        want, _ = jm.apply(params, state, jnp.asarray(x),
                           jnn.Ctx(train=False))
        with torch.no_grad():
            got = tm(nchw(x)).numpy()
        close_scaled(got, want, 1e-4, f"embedding at {size} px")


def test_psp_facerec_train_mode_matches_jax(facerec_pair):
    jm, params, state = facerec_pair
    tm = _port_facerec(params, state)
    x = np.random.RandomState(8).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    _check_train_mode(jm, params, state, tm, x)


def test_from_jax_is_strict(facerec_pair):
    jm, params, state = facerec_pair
    tm = psp.PSpFaceRec(size=32, emb_size=64)
    tiny_port(tm, tm.encoder)
    sd = from_jax(tm, params, state)
    assert set(sd) == set(tm.state_dict())
    assert sd["avg_image"].shape == (3, 32, 32)
    bad = dict(params)
    bad["encoder"] = {k: v for k, v in params["encoder"].items()
                      if k != "output_layer"}
    with pytest.raises(KeyError):
        from_jax(tm, bad, state)


def test_flatten_linear_permutation_non_square():
    """A Linear after a Flatten of a 3 x 5 map: the JAX (H, W, C) input
    order becomes the port's (C, H, W)."""
    c, h, w = 6, 3, 5
    jm = jnn.Sequential(jnn.BatchNorm2d(c), jnn.Flatten(),
                        jnn.Linear(c * h * w, 7), jnn.BatchNorm1d(7))
    params, state = perturbed(jm, 9)
    x = np.random.RandomState(10).randn(2, h, w, c).astype(np.float32)
    want, _ = jm.apply(params, state, jnp.asarray(x), jnn.Ctx(train=False))
    tm = torch.nn.Sequential(BatchNorm2d(c), Flatten((h, w)),
                             torch.nn.Linear(c * h * w, 7), BatchNorm1d(7))
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    with torch.no_grad():
        got = tm.eval()(nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    unmarked = torch.nn.Sequential(BatchNorm2d(c), Flatten(),
                                   torch.nn.Linear(c * h * w, 7),
                                   BatchNorm1d(7))
    with pytest.raises(ValueError, match="hw"):
        from_jax(unmarked, params, state)


@pytest.mark.parametrize("in_c,depth", [(16, 32), (32, 32)])
def test_block_dropout_placement_and_scaling(in_c, depth):
    """Dropout after res_layer 1 and 3 and after a conv shortcut, masks
    drawn from the generator in that order (shortcut first), kept
    elements divided by 1 - p; eval mode and p = 0 draw nothing."""
    p = 0.25
    block = irse.BottleneckIR(in_c, depth, 2, se=True, dropout=p)
    x = torch.randn(2, in_c, 8, 8, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    block.drop.generator = gen
    with torch.no_grad():
        block.eval()
        ref = block(x)
        assert gen.initial_seed() == 11
        block.train()
        got = block(x)

        replay = torch.Generator().manual_seed(11)

        def drop(t):
            mask = torch.empty_like(t).bernoulli_(1 - p, generator=replay)
            return t * mask / (1 - p)

        shortcut = block.shortcut_layer(x)
        if in_c != depth:
            shortcut = drop(shortcut)
        h = x
        for i, layer in enumerate(block.res_layer):
            h = layer(h)
            if i in (1, 3):
                h = drop(h)
        np.testing.assert_array_equal(got.numpy(), (h + shortcut).numpy())
        assert not torch.equal(got, ref)
    d = Dropout(0.5).train()
    d.generator = torch.Generator().manual_seed(1)
    y = d(torch.ones(1000))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert 0.4 < float((y > 0).float().mean()) < 0.6
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.5).train()(torch.ones(3))


def test_output_layer_dropout_rates():
    """Backbone's output dropout is its drop_ratio; the pSp facerec head's
    is 0.5; block dropout reaches every unit."""
    bb = irse.IR_SE_50(112, drop_ratio=0.4, block_dropout=0.15)
    assert isinstance(bb.output_layer[1], Dropout)
    assert bb.output_layer[1].p == 0.4
    assert all(u.drop.p == 0.15 for u in bb.body)
    enc = psp.PSpFaceRec(block_dropout=0.15).encoder
    assert enc.output_layer[1].p == 0.5 and len(enc.body) == 24
    assert psp.PSpFaceRec().encoder.body[0].drop is None
    assert enc.output_layer[3].in_features == 512 * 7 * 7
    assert isinstance(psp.BackboneEncoderDiffHead(
        output_layer_type="pSp").output_layer, psp.PSPOutputLayer)
    with pytest.raises(ValueError, match="output_layer_type"):
        psp.BackboneEncoderDiffHead(output_layer_type="styles")


@pytest.mark.parametrize("layer", ["2d", "1d"])
def test_ghost_bn_matches_jax_bn_groups(layer):
    """bn_groups = 4: each contiguous quarter of the batch normalized with
    its own statistics, the running statistics from group 0."""
    rng = np.random.RandomState(12)
    shape = (8, 5, 5, 6) if layer == "2d" else (8, 6)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    x[:2] += 3.0
    jm = jnn.BatchNorm(6)
    params, state = perturbed(jm, 13)
    params["weight"] = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    want, new_state = jm.apply(params, state, jnp.asarray(x),
                               jnn.Ctx(train=True, bn_groups=4))
    tm = (BatchNorm2d if layer == "2d" else BatchNorm1d)(6)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    tm.bn_groups = 4
    with torch.no_grad():
        got = tm.train()(nchw(x) if layer == "2d" else torch.from_numpy(x))
    got = np.moveaxis(got.numpy(), 1, -1) if layer == "2d" else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(new_state["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(new_state["var"]), rtol=1e-5,
                               atol=1e-6)
    tm.bn_groups = None
    with torch.no_grad():
        plain = tm(nchw(x) if layer == "2d" else torch.from_numpy(x))
    assert not np.allclose(np.moveaxis(plain.numpy(), 1, -1)
                           if layer == "2d" else plain.numpy(), got,
                           atol=1e-3)
    with pytest.raises(ValueError, match="groups"):
        tm.bn_groups = 3
        tm(torch.zeros((8,) + tuple(tm.running_mean.shape)))


def test_irse_id_extractor_matches_jax():
    """The ID loss's IR-SE-50 at 112 px in eval mode (the full network),
    fed 64 px images: crop, pool, embed, normalise; and ``id_loss``."""
    jm = jirse.Backbone(input_size=112, num_layers=50, mode="ir_se",
                        drop_ratio=0.6)
    params, state = perturbed(jm, 14)
    rng = np.random.RandomState(15)
    y_hat, y, x = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
                   for _ in range(3))
    jextract = jax.jit(jident.make_irse_id_extractor(params, state))
    tm = load_from_jax(irse.IR_SE_50(112), params, state)
    extract = make_irse_id_extractor(tm)
    assert not tm.training
    with torch.no_grad():
        got = extract(torch.from_numpy(y)).numpy()
        loss, sim, logs = id_loss(tm, torch.from_numpy(y_hat),
                                  torch.from_numpy(y), torch.from_numpy(x))
    want = np.asarray(jextract(jnp.asarray(y)))
    assert got.shape == (2, 512)
    close_scaled(got, want, 1e-4, "ID features")
    jl, jsim, _ = jident.similarity_loss(jextract, jnp.asarray(y_hat),
                                         jnp.asarray(y), jnp.asarray(x))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(sim), float(jsim), atol=1e-4)
    assert sorted(logs) == ["diff_input", "diff_target", "diff_views"]
