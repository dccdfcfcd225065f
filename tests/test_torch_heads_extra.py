"""The port's extra margin heads against the JAX package's
(``models/heads_extra.py``), on the CPU in f32: ``AMSoftmaxV2``,
``ArcNegFace``, ``CircleLoss``, ``MagFace``, ``MVSoftmax`` (arc and
additive), ``NPCFace`` and ``SSTPrototype`` (its three margins), at 32
features, 50 classes (a queue of 24), batch 10.

Each head's weights are the JAX head's ``init`` carried by the port's
``from_jax``. Features are seeded normals (times 30 for MagFace, so their
norms fall inside its [10, 110] band).

Tolerances: logits 1e-5 of their scale; the gradients of a seeded random
weighting of the logits with respect to the features and the class
weights 2e-3 of each one's largest (the matmul and the norms sum in
another order than XLA's). ``SSTPrototype``: four steps over a queue that
wraps around, each with the coin the JAX step drew (read from which view
it wrote): logits as above, and the queue, cursor and labels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu import nn as jnn
from stylegan_for_facerec_tpu.models import heads_extra as jhx
from stylegan_for_facerec_torch.models import heads_extra as hx
from stylegan_for_facerec_torch.utils.convert import from_jax

D, C, N = 32, 50, 10
HEADS = [("AMSoftmaxV2", {}), ("ArcNegFace", {}), ("CircleLoss", {}),
         ("MagFace", {}), ("MVSoftmax", {}), ("MVSoftmax", {"is_am": True}),
         ("NPCFace", {})]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what):
    want = np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} * {scale:.3e}"


@pytest.mark.parametrize("name,kw", HEADS,
                         ids=[f"{n}{'_am' if k else ''}" for n, k in HEADS])
def test_head_matches_jax(name, kw):
    jm = getattr(jhx, name)(D, C, **kw)
    params, state = jm.init(jax.random.key(0))
    tm = getattr(hx, name)(D, C, **kw)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    rng = np.random.RandomState(1)
    feats = rng.randn(N, D).astype(np.float32) * (30 if name == "MagFace"
                                                  else 1)
    labels = rng.randint(0, C, N)
    w = rng.randn(N, C).astype(np.float32)

    def jloss(p, f):
        out, _ = jm.apply(p, state, (f, jnp.asarray(labels)), jnn.Ctx())
        logits, reg = out if name == "MagFace" else (out, jnp.zeros(()))
        return jnp.sum(logits * w) + jnp.sum(reg), (logits, reg)

    (_, (want, want_reg)), (gp, gf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    out = tm(f, torch.from_numpy(labels))
    logits, reg = out if name == "MagFace" else (out, torch.zeros(()))
    ((logits * torch.from_numpy(w)).sum() + reg.sum()).backward()
    _close(logits.detach(), want, 1e-5, "logits")
    _close(reg.detach(), want_reg, 1e-5, "regularizer")
    _close(f.grad, gf, 2e-3, "feature gradient")
    (pname, p), = tm.named_parameters()
    _close(p.grad, gp[pname], 2e-3, "weight gradient")


def test_renorm_init_gives_unit_columns_from_a_seed():
    a, b = hx.AMSoftmaxV2(D, C), hx.AMSoftmaxV2(D, C)
    assert torch.equal(a.weight, b.weight)
    torch.testing.assert_close(a.weight.norm(dim=0), torch.ones(C))
    a.init_weights_(torch.Generator().manual_seed(5))
    assert not torch.equal(a.weight, b.weight)
    assert hx.NPCFace(D, C).kernel.shape == (D, C)
    assert hx.ArcNegFace(D, C).weight.shape == (C, D)


def _sst_coin(jnew_queue, cols, g1, g2):
    """True where the JAX step wrote g1's columns, False for g2's."""
    cols = np.asarray(cols)
    written = np.asarray(jnew_queue)[:, cols].T
    n1 = g1 / np.linalg.norm(g1, axis=1, keepdims=True)
    n2 = g2 / np.linalg.norm(g2, axis=1, keepdims=True)
    is1, is2 = np.allclose(written, n1), np.allclose(written, n2)
    assert is1 != is2
    return is1


@pytest.mark.parametrize("loss_type", ["softmax", "am_softmax",
                                       "arc_softmax"])
def test_sst_prototype_matches_jax_over_a_wraparound(loss_type):
    q = 24
    jm = jhx.SSTPrototype(feat_dim=D, queue_size=q, loss_type=loss_type,
                          margin=0.2)
    params, state = jm.init(jax.random.key(0))
    tm = hx.SSTPrototype(feat_dim=D, queue_size=q, loss_type=loss_type,
                         margin=0.2)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    rng = np.random.RandomState(2)
    for step in range(4):
        views = [rng.randn(N, D).astype(np.float32) for _ in range(4)]
        ids = rng.randint(0, 1000, N)
        w = rng.randn(N, q).astype(np.float32)

        def jloss(p1, p2):
            (o1, o2, lab), new = jm.apply(
                {}, state, (p1, jnp.asarray(views[1]), p2,
                            jnp.asarray(views[3]), jnp.asarray(ids)),
                jnn.Ctx(rng=jax.random.key(10 + step)))
            return jnp.sum((o1 + 2 * o2) * w), (o1, o2, lab, new)

        (_, (o1, o2, lab, new)), (g1, g2) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(views[0]),
                                                 jnp.asarray(views[2]))
        coin = _sst_coin(new["queue"], lab, views[3], views[1])
        p1 = torch.from_numpy(views[0]).requires_grad_(True)
        p2 = torch.from_numpy(views[2]).requires_grad_(True)
        t1, t2, tlab = tm(p1, torch.from_numpy(views[1]), p2,
                          torch.from_numpy(views[3]), torch.from_numpy(ids),
                          coin=coin)
        ((t1 + 2 * t2) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(lab))
        _close(t1.detach(), o1, 1e-5, f"step {step} logits1")
        _close(t2.detach(), o2, 1e-5, f"step {step} logits2")
        _close(p1.grad, g1, 2e-3, f"step {step} p1 gradient")
        _close(p2.grad, g2, 2e-3, f"step {step} p2 gradient")
        _close(tm.queue, new["queue"], 1e-6, f"step {step} queue")
        assert int(tm.index) == int(new["index"])
        np.testing.assert_array_equal(tm.labels.numpy(),
                                      np.asarray(new["labels"]))
        state = new
    assert int(tm.index) == (4 * N) % q        # wrapped around


def test_sst_prototype_coin_from_the_generator():
    """The same CPU generator seed gives the same queue; no generator and
    no coin raises."""
    rng = np.random.RandomState(3)
    views = [torch.from_numpy(rng.randn(N, D).astype(np.float32))
             for _ in range(4)]
    ids = torch.arange(N)
    a, b = hx.SSTPrototype(D, 24), hx.SSTPrototype(D, 24)
    with pytest.raises(ValueError, match="Generator"):
        a(*views, ids)
    for m in (a, b):
        m(*views, ids, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.queue, b.queue)
    assert a.labels[:N].tolist() == list(range(N))
    assert (a.labels[N:] == -1).all()
