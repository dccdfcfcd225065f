"""The port's margin heads and stage-3 losses against the JAX package's, on
the CPU in f32: every margin function, every head of ``HEAD_REGISTRY``
(weights carried with ``from_jax``, two forwards so the stateful heads'
buffers carry), the focal and cross-entropy losses and top-k accuracy,
within 1e-5 (and a gradient through ArcFace + focal within 1e-5 of
scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.losses import focal as jfocal
from stylegan_for_facerec_tpu.models import heads as jheads
from stylegan_for_facerec_torch.losses import focal
from stylegan_for_facerec_torch.models import heads
from stylegan_for_facerec_torch.utils.convert import from_jax

D, C, B = 16, 24, 6


def _data(seed, scale=3.0):
    rng = np.random.RandomState(seed)
    f = (rng.randn(B, D) * scale).astype(np.float32)
    labels = rng.randint(0, C, B).astype(np.int32)
    return f, labels


def _cosine(seed):
    rng = np.random.RandomState(seed)
    cos = rng.uniform(-1, 1, (B, C)).astype(np.float32)
    cos[0, :4] = [-0.99, -0.9, 0.999, 1.0]     # past th, near the clamp
    labels = rng.randint(0, C, B)
    labels[0] = 0
    one_hot = np.eye(C, dtype=np.float32)[labels]
    return cos, one_hot


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5, err_msg=what)


def test_cosine_logits():
    f, _ = _data(0)
    w = np.random.RandomState(1).randn(C, D).astype(np.float32)
    close(heads.cosine_logits(torch.from_numpy(f), torch.from_numpy(w)),
          jheads.cosine_logits(jnp.asarray(f), jnp.asarray(w)))
    z = np.zeros((2, D), np.float32)       # the eps of F.normalize
    close(heads._normalize(torch.from_numpy(z)),
          jheads._normalize(jnp.asarray(z)))


@pytest.mark.parametrize("kind,kw", [
    ("arcface", {}), ("arcface", {"s": 30.0, "m": 0.3}),
    ("arcface", {"easy_margin": True}), ("cosface", {}),
    ("cosface", {"s": 30.0, "m": 0.35}), ("am_softmax", {}),
    ("am_softmax", {"s": 10.0, "m": 0.2})])
def test_margin_functions(kind, kw):
    cos, one_hot = _cosine(2)
    got = heads.margin_logits(kind, torch.from_numpy(cos),
                              torch.from_numpy(one_hot), **kw)
    want = jheads.margin_logits(kind, jnp.asarray(cos), jnp.asarray(one_hot),
                                **kw)
    close(got, want, kind)
    if kind == "arcface":
        close(heads.arcface_margin(torch.from_numpy(cos),
                                   torch.from_numpy(one_hot), **kw), want)


def test_margin_logits_rejects_unknown_kind():
    with pytest.raises(ValueError):
        heads.margin_logits("nope", torch.zeros(1, 2), torch.zeros(1, 2))


@pytest.mark.parametrize("name", sorted(heads.HEAD_REGISTRY))
def test_head_matches_jax(name):
    jm = jheads.build_head(name, D, C)
    params, state = jm.init(jax.random.key(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    tm = heads.build_head(name, D, C)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    for step in range(2):
        f, labels = _data(4 + step)
        want, state = jm.apply(params, state,
                               (jnp.asarray(f), jnp.asarray(labels)), None)
        got = tm(torch.from_numpy(f), torch.from_numpy(labels).long())
        assert got.shape == (B, C)
        close(got.detach(), want, f"{name} step {step}")
        for k, v in state.items():
            close(getattr(tm, k), v, f"{name} {k} after step {step}")
    assert sorted(dict(tm.named_buffers())) == sorted(state)


def test_head_weights_are_seeded():
    a = heads.build_head("ArcFace", D, C)
    b = heads.build_head("ArcFace", D, C)
    assert torch.equal(a.weight, b.weight)
    bound = (6.0 / (D + C)) ** 0.5
    assert float(a.weight.detach().abs().max()) <= bound
    a.init_weights_(torch.Generator().manual_seed(1))
    assert not torch.equal(a.weight, b.weight)
    k = heads.build_head("Am_softmax", D, C).kernel
    np.testing.assert_allclose(torch.linalg.norm(k, dim=0).detach().numpy(),
                               1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown head"):
        heads.build_head("nope", D, C)


def _logits(seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(B, C) * 5).astype(np.float32),
            rng.randint(0, C, B).astype(np.int32))


@pytest.mark.parametrize("fn", ["cross_entropy_per_sample", "focal_loss",
                                "focal_loss_per_sample",
                                "softmax_cross_entropy"])
def test_losses_match_jax(fn):
    logits, labels = _logits(6)
    got = getattr(focal, fn)(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    want = getattr(jfocal, fn)(jnp.asarray(logits), jnp.asarray(labels))
    close(got, want, fn)
    # bf16 logits: the log-softmax still runs in f32
    got16 = getattr(focal, fn)(torch.from_numpy(logits).bfloat16(),
                               torch.from_numpy(labels))
    assert got16.dtype == torch.float32


def test_focal_is_applied_to_the_mean_ce():
    logits, labels = _logits(7)
    ce = torch.nn.functional.cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels).long())
    want = (1 - torch.exp(-ce)) ** 2 * ce
    close(focal.focal_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels)), want)


@pytest.mark.parametrize("k", [1, 5, 100])
def test_topk_accuracy_matches_jax(k):
    logits, labels = _logits(8)
    labels[:2] = np.argsort(-logits[:2], axis=1)[:, 2]   # a top-3 hit
    got = focal.topk_accuracy(torch.from_numpy(logits),
                              torch.from_numpy(labels), k)
    want = jfocal.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), k)
    close(got, want, f"top{k}")


def test_arcface_focal_gradient_matches_jax():
    f, labels = _data(9)
    w = np.random.RandomState(10).randn(C, D).astype(np.float32)

    def jloss(f, w):
        one_hot = jax.nn.one_hot(labels, C)
        logits = jheads.arcface_margin(jheads.cosine_logits(f, w), one_hot)
        return jfocal.focal_loss(logits, jnp.asarray(labels))

    jgf, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(w))
    tf = torch.from_numpy(f).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    one_hot = torch.nn.functional.one_hot(torch.from_numpy(labels).long(),
                                          C).float()
    loss = focal.focal_loss(heads.arcface_margin(
        heads.cosine_logits(tf, tw), one_hot), torch.from_numpy(labels))
    loss.backward()
    for got, want in ((tf.grad, jgf), (tw.grad, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
