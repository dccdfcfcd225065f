"""The port's stage-3 trainer against the JAX package's ``Stage3Trainer``,
on the CPU in f32.

Configuration: ``PSpFaceRec`` with the 4-unit body at 32 px (the layout of
``tests/test_train_stage3.py``), a non-zero average image, 64 classes,
ArcFace + focal, SGD lr 0.03 momentum 0.9 weight decay 2e-3 (BatchNorm
exempt), a schedule that decays at epoch 1 of 2 steps, batch 8; dropout
and augmentation off on both sides. Three steps: the first with the body
frozen, then two unfrozen, with step arguments that differ from the
optimizer's count (the learning rate follows the count).

Tolerances, with their reasons:
  * loss, top-1 and top-5: 1e-4 relative (the forward passes through the
    convolutions in another summation order than XLA's);
  * each parameter's update since the start: 2e-3 of that tensor's
    largest update, plus 1e-6 of the largest update of any tensor and 4
    f32 ulps of the parameter (the stage-2 comparison's rule);
  * momentum buffers: 2e-3 of each buffer's largest magnitude plus the
    same floor; BatchNorm running statistics: 1e-4 of scale (a running
    mean against the layer's spread, sqrt of its largest running var).

SGD passes the gradient straight into the update, so a PReLU or ReLU
input within f32 rounding of 0, which takes the other branch in one
framework, moves a weight gradient by up to ~1 %: with the batches of
seed 10 the JAX step differs so from a float64 run of the port at unit
0's first convolution (0.87 % of its largest gradient) while the port's
f32 step agrees with it to 2.3e-6. The batches here (seeds 22-24) have no
such element in these three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.train import Stage3Config as JConfig
from stylegan_for_facerec_tpu.train import Stage3Trainer as JTrainer
from stylegan_for_facerec_tpu.train import optim as joptim
from stylegan_for_facerec_torch.models import psp
from stylegan_for_facerec_torch.nn.layers import Dropout
from stylegan_for_facerec_torch.train import optim
from stylegan_for_facerec_torch.train.stage3 import (Stage3Config,
                                                     Stage3Trainer)
from stylegan_for_facerec_torch.utils.convert import (from_jax,
                                                      load_stage3_from_jax)
from test_torch_facerec_models import JTinyPSpFaceRec, tiny_port

CFG = dict(emb_size=64, num_classes=64, batch_size=8, lr=0.03,
           momentum=0.9, weight_decay=2e-3, stages=(1,),
           freeze_backbone_epochs=1, compute_dtype="float32")
STEPS = [(5, True), (0, False), (3, False)]     # (step argument, frozen)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_trainer(seed=0, **kw):
    bb = psp.PSpFaceRec(size=32, emb_size=64, block_dropout=0.1)
    tiny_port(bb, bb.encoder, dropout=0.1)
    return Stage3Trainer(bb, Stage3Config(**dict(CFG, **kw)),
                         steps_per_epoch=2, device="cpu", seed=seed)


def _batch(seed, n=8):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32),
            rng.randint(0, 64, n).astype(np.int32))


def _sd(trainer):
    out = {f"backbone.{k}": v.detach().numpy().copy()
           for k, v in trainer.backbone.state_dict().items()}
    out["head.weight"] = trainer.head_weight.detach().numpy().copy()
    return out


def _jax_sd(tm, tree, state):
    """A JAX params-shaped tree in the port's layout, keyed like ``_sd``."""
    out = {f"backbone.{k}": v.numpy() for k, v in
           from_jax(tm, tree["backbone"], state["backbone"]).items()}
    out["head.weight"] = np.asarray(tree["head"]["weight"])
    return out


@pytest.fixture(scope="module")
def run():
    jt = JTrainer(JTinyPSpFaceRec(size=32, emb_size=64),
                  JConfig(**CFG), steps_per_epoch=2)
    params, state, opt = jt.init(jax.random.key(0))
    rng = np.random.RandomState(1)
    state["backbone"]["avg_image"] = jnp.asarray(
        rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32))
    tt = port_trainer()
    for m in tt.backbone.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    load_stage3_from_jax(tt, params, state)
    out = {"sd0": _sd(tt), "tt": tt, "steps": []}
    for i, (step, frozen) in enumerate(STEPS):
        x, y = _batch(22 + i)
        mask = jt.freeze_mask(params, frozen=frozen)
        params, state, opt, jm = jt.train_step(
            params, state, opt, jnp.asarray(x), jnp.asarray(y),
            jax.random.key(2 + i), jnp.asarray(step), mask)
        tm = tt.train_step(torch.from_numpy(x), torch.from_numpy(y), step,
                           tt.freeze_mask(frozen))
        names = dict((id(p), k) for k, p in tt.named_parameters())
        out["steps"].append(dict(
            jm={k: float(v) for k, v in jm.items()},
            tm={k: float(v) for k, v in tm.items()},
            want=_jax_sd(tt.backbone, params, state), got=_sd(tt),
            want_buf=_jax_sd(tt.backbone, opt[0].trace, state),
            got_buf={names[id(p)]: s["momentum_buffer"].numpy().copy()
                     for p, s in tt.optimizer.state.items()},
            count=int(opt[1].count), opt_count=tt.opt_count))
    return out


def _updates_close(sd0, want, got, keys):
    floor = 1e-6 * max(np.abs(want[k] - sd0[k]).max() for k in keys)
    worst = []
    for k in keys:
        want_u, got_u = want[k] - sd0[k], got[k] - sd0[k]
        tol = (2e-3 * np.abs(want_u).max() + floor
               + 4 * np.spacing(np.abs(want[k]).astype(np.float32)))
        worst.append((float((np.abs(got_u - want_u) / tol).max()), k))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1.0, worst[:5]


@pytest.mark.parametrize("i", range(len(STEPS)))
def test_train_step_matches_jax(run, i):
    r = run["steps"][i]
    assert sorted(r["tm"]) == sorted(r["jm"]) == ["loss", "lr", "top1",
                                                  "top5"]
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(r["tm"][k], r["jm"][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(r["tm"]["lr"], r["jm"]["lr"], rtol=1e-7)
    assert r["opt_count"] == r["count"] == i + 1
    sd0, want, got = run["sd0"], r["want"], r["got"]
    params = [k for k, _ in run["tt"].named_parameters()]
    _updates_close(sd0, want, got, params)
    for k in want:
        if k.endswith("running_mean"):
            var = want[k[:-len("mean")] + "var"]
            for name, scale in ((k, np.sqrt(var.max())),
                                (k[:-len("mean")] + "var", var.max())):
                np.testing.assert_allclose(got[name], want[name], rtol=0,
                                           atol=1e-4 * scale, err_msg=name)
                assert not np.array_equal(want[name], sd0[name]), name
    # momentum: the port creates a buffer at a parameter's first gradient
    # (a frozen parameter has none); JAX's frozen buffers stay 0
    bufs = r["got_buf"]
    floor = 1e-6 * max(np.abs(r["want_buf"][k]).max() for k in params)
    for k in params:
        want_b = r["want_buf"][k]
        got_b = bufs.get(k, np.zeros_like(want_b))
        tol = 2e-3 * np.abs(want_b).max() + floor
        assert np.abs(got_b - want_b).max() <= tol, k
    frozen = [k for k in params if ".encoder.body." in k]
    assert (set(bufs) & set(frozen)) == (set() if i == 0 else set(frozen))


def test_frozen_body_is_bit_equal(run):
    """Over the frozen step the body's parameters do not move at all (no
    gradient, decay or momentum); its BatchNorm statistics and the input
    layer, output layer and head do."""
    sd0, got = run["sd0"], run["steps"][0]["got"]
    body = [k for k, _ in run["tt"].named_parameters()
            if ".encoder.body." in k]
    assert len(body) > 30
    for k in body:
        np.testing.assert_array_equal(got[k], sd0[k], err_msg=k)
    for k in ("backbone.encoder.input_layer.0.weight",
              "backbone.encoder.output_layer.3.weight", "head.weight",
              "backbone.encoder.body.0.res_layer.0.running_mean"):
        assert not np.array_equal(got[k], sd0[k]), k


def test_batchnorm_is_exempt_from_weight_decay():
    tt = port_trainer()
    decay_g, bn_g = tt.optimizer.param_groups
    assert decay_g["weight_decay"] == 2e-3 and bn_g["weight_decay"] == 0.0
    names = {id(p): k for k, p in tt.named_parameters()}
    bn_names = {names[id(p)] for p in bn_g["params"]}
    mods = dict(tt.backbone.named_modules())
    for k in bn_names:
        owner = mods[k[len("backbone."):].rsplit(".", 1)[0]]
        assert isinstance(owner, torch.nn.modules.batchnorm._BatchNorm), k
    decays = {names[id(p)] for p in decay_g["params"]}
    assert "head.weight" in decays
    assert "backbone.encoder.input_layer.2.weight" in decays     # PReLU
    assert len(bn_names) + len(decays) == len(names)
    # the JAX package's mask over the same layer classes
    bb = JTinyPSpFaceRec(size=32, emb_size=64)
    jmask = joptim.batchnorm_decay_mask(bb)(bb.init(jax.random.key(0))[0])
    n_exempt = sum(not v for v in jax.tree_util.tree_leaves(jmask))
    assert n_exempt == len(bn_names)


def test_schedule_matches_jax():
    kw = dict(base_lr=0.03, warmup_batches=5, steps_per_epoch=10,
              stages=(2, 4))
    port, jax_s = optim.Stage3Schedule(**kw), joptim.Stage3Schedule(**kw)
    for step in range(0, 60, 3):
        assert port(step) == float(jax_s(step)), step
    assert port(0) == pytest.approx(0.03 / 5)
    assert port(45) == pytest.approx(0.03 / 1.5 ** 2)


def _leaf_order(tree, prefix=""):
    """A JAX tree's leaf names in its dicts' insertion order, the order
    ``increasing_layer_decay_mask`` walks."""
    out = []
    for k, v in tree.items():
        out += (_leaf_order(v, f"{prefix}{k}.") if isinstance(v, dict)
                else [prefix + k])
    return out


def test_increasing_layer_decay_mask_matches_jax():
    """The ratios depend on the order of the parameters: given the JAX
    tree's walk order (in which the body comes before the input layer),
    the port equals JAX; given the port's module order, depth grows from
    the input layer."""
    params = JTinyPSpFaceRec(size=32, emb_size=64).init(
        jax.random.key(0))[0]
    want = joptim.increasing_layer_decay_mask(params, first_layer_lr=0.1)
    jax_order = _leaf_order(params)
    got = optim.increasing_layer_decay_mask(jax_order, first_layer_lr=0.1)
    for name in jax_order:
        node = want
        for part in name.split("."):
            node = node[part]
        assert got[name] == pytest.approx(float(node), rel=1e-6), name
    names = [k for k, _ in port_trainer().backbone.named_parameters()]
    assert sorted(names) == sorted(jax_order) and names != jax_order
    got = optim.increasing_layer_decay_mask(names, first_layer_lr=0.1)
    n_weights = sum(k.endswith("weight") for k in names)
    assert got[names[0]] == pytest.approx(0.1 + 0.9 / n_weights)
    assert got[names[-1]] == pytest.approx(1.0)


def test_learning_rate_follows_the_optimizer_count():
    """Step arguments far past the stages do not decay the rate the update
    uses; the reported lr is the schedule at the step argument."""
    tt = port_trainer()
    x, y = _batch(3)
    m = tt.train_step(torch.from_numpy(x), torch.from_numpy(y), 99)
    assert tt.optimizer.param_groups[0]["lr"] == pytest.approx(0.03)
    assert m["lr"] == pytest.approx(0.03 / 1.5)
    tt.train_step(torch.from_numpy(x), torch.from_numpy(y), 0)
    tt.train_step(torch.from_numpy(x), torch.from_numpy(y), 0)
    assert tt.opt_count == 3
    assert tt.optimizer.param_groups[0]["lr"] == pytest.approx(0.03 / 1.5)


def test_bf16_loss_close_to_f32_and_state_stays_f32():
    x, y = _batch(4)
    losses = {}
    for dt in ("float32", "bfloat16"):
        tt = port_trainer(compute_dtype=dt)
        for m in tt.backbone.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        losses[dt] = float(tt.train_step(torch.from_numpy(x),
                                         torch.from_numpy(y), 0)["loss"])
    assert np.isfinite(losses["bfloat16"])
    assert losses["bfloat16"] == pytest.approx(losses["float32"], rel=0.05)
    for v in list(tt.backbone.state_dict().values()) + [tt.head_weight]:
        if v.is_floating_point():
            assert v.dtype == torch.float32
    for st in tt.optimizer.state.values():
        assert st["momentum_buffer"].dtype == torch.float32


def test_bf16_cosine_accumulates_in_f32():
    """The bf16 cosine is the f32 product of bf16-rounded operands, not a
    bf16 matmul's rounded output."""
    tt = port_trainer(compute_dtype="bfloat16")
    f = torch.randn(8, 64, generator=torch.Generator().manual_seed(5))
    labels = torch.arange(8)
    got = tt._margin_logits(f, labels)
    fn = f / f.norm(dim=1, keepdim=True)
    wn = tt.head_weight / tt.head_weight.norm(dim=1, keepdim=True)
    cos = fn.bfloat16().float() @ wn.bfloat16().float().t()
    one_hot = torch.nn.functional.one_hot(labels, 64).float()
    from stylegan_for_facerec_torch.models.heads import arcface_margin
    torch.testing.assert_close(got, arcface_margin(cos, one_hot),
                               rtol=1e-6, atol=1e-5)
    rounded = arcface_margin((fn.bfloat16() @ wn.bfloat16().t()).float(),
                             one_hot)
    assert not torch.equal(got, rounded)


def test_uint8_images_map_to_pm1_and_crop_runs():
    """uint8 input is x / 127.5 - 1; with augment_crop the step crops and
    flips with the trainer's generator, the same draws for the same
    seed."""
    x8 = np.random.RandomState(6).randint(0, 256, (8, 32, 32, 3),
                                          dtype=np.uint8)
    _, y = _batch(6)
    a, b = port_trainer(), port_trainer()
    ma = a.train_step(torch.from_numpy(x8), torch.from_numpy(y), 0)
    mb = b.train_step(torch.from_numpy(x8.astype(np.float32) / 127.5 - 1.0),
                      torch.from_numpy(y), 0)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)
    c, d = port_trainer(augment_crop=28), port_trainer(augment_crop=28)
    big = np.random.RandomState(7).randint(0, 256, (8, 36, 36, 3),
                                           dtype=np.uint8)
    mc = c.train_step(torch.from_numpy(big), torch.from_numpy(y), 0)
    md = d.train_step(torch.from_numpy(big), torch.from_numpy(y), 0)
    assert float(mc["loss"]) == float(md["loss"])
    assert np.isfinite(float(mc["loss"]))


def test_checkpoint_round_trip_and_embed():
    tt = port_trainer()
    x, y = _batch(8)
    tt.train_step(torch.from_numpy(x), torch.from_numpy(y), 0)
    payload = tt.state_dict()
    assert payload["opt_count"] == 1
    assert payload["avg_image"].shape == (32, 32, 3)
    fresh = port_trainer(seed=1)
    fresh.load_state_dict(payload)
    assert fresh.opt_count == 1
    for (k, v), w in zip(tt.backbone.state_dict().items(),
                         fresh.backbone.state_dict().values()):
        assert torch.equal(v, w), k
    e1, e2 = tt.embed(torch.from_numpy(x)), fresh.embed(torch.from_numpy(x))
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)
    assert e1.shape == (8, 64) and tt.backbone.training
    # dropout is off (p = 0), so the resumed trainer takes the same step
    m1 = tt.train_step(torch.from_numpy(x), torch.from_numpy(y), 1)
    m2 = fresh.train_step(torch.from_numpy(x), torch.from_numpy(y), 1)
    assert float(m1["loss"]) == float(m2["loss"])
    np.testing.assert_allclose(_sd(tt)["head.weight"],
                               _sd(fresh)["head.weight"], rtol=0, atol=0)


def test_ghost_bn_groups_reach_every_batchnorm():
    tt = port_trainer(bn_groups=2)
    bns = [m for m in tt.backbone.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert bns and all(m.bn_groups == 2 for m in bns)
    x, y = _batch(9)
    assert np.isfinite(float(tt.train_step(torch.from_numpy(x),
                                           torch.from_numpy(y), 0)["loss"]))
