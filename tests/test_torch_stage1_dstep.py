"""The port's stage-1 D loss against the JAX package's
``Stage1Trainer._d_loss``, on the CPU in f32, without and with lazy R1.

Configuration: ``Stage1Config(image_size=32, batch_size=4)`` (the layout of
``tests/test_stage1_gan.py``), JAX init weights carried over by
``load_stage1_from_jax``, every synthesis layer's noise_strength set away
from 0 (so the fakes' layer noise counts), ADA at p = 0.5 (every group
fires on some images). Both sides take the same draws: z, the layer noise
``normal(fold_in(k1, i), ...)`` and the ADA parameters of reals (k2) and
fakes (k3), with ``k1, k2, k3 = split(rng, 3)`` as ``_d_loss`` splits.

Tolerances: loss 1e-5 relative; rt exactly (a mean of signs); each D
gradient within 2e-3 of that tensor's largest element (convolutions and
R1's double backward sum in other orders than XLA's; measured worst
7.3e-4, a bias's sum over the batch and the map).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stage1_parity import (d_draws, jax_trainer_and_state, port_trainer,
                           rel_err)
from stylegan_for_facerec_torch.utils.convert import from_jax
from torch_mp_shared import shared_result


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    jt, st = jax_trainer_and_state()
    fn = jax.jit(jax.value_and_grad(jt._d_loss, has_aux=True),
                 static_argnames=("do_r1",))
    return jt, st, fn


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "r1"])
def case(request, tmp_path_factory):
    """(port loss, rt, D grads by torch name; JAX's) for one D loss,
    computed once a session."""
    return shared_result(
        tmp_path_factory, f"stage1_dstep_{request.param}",
        lambda: _case(request.getfixturevalue("jax_side"), request.param))


def _case(jax_side, do_r1):
    _, st, fn = jax_side
    rs = np.random.RandomState(1)
    reals = rs.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    z = rs.randn(4, 512).astype(np.float32)
    rng = jax.random.key(5)
    (loss, rt), grads = fn(st["d"], st["g"], st["g_state"],
                           jnp.asarray(reals), jnp.asarray(z), st["ada_p"],
                           rng, do_r1=do_r1)
    tr = port_trainer(st)
    p_loss, p_rt = tr.d_loss(torch.from_numpy(reals), d_draws(rng, z), do_r1)
    p_loss.backward()
    want = from_jax(tr.D, jax.tree_util.tree_map(np.asarray, grads), {})
    got = {n: p.grad.numpy() for n, p in tr.D.named_parameters()}
    g_grads = [p.grad for p in tr.G.parameters()]
    return {"loss": (p_loss.item(), float(loss)), "rt": (p_rt.item(),
                                                         float(rt)),
            "grads": (got, want), "g_grads": g_grads,
            "w_avg": (tr.G.mapping.w_avg.numpy(),
                      np.asarray(st["g_state"]["mapping"]["w_avg"]))}


def test_d_loss_matches_jax(case):
    got, want = case["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_d_rt_matches_jax(case):
    got, want = case["rt"]
    assert got == want


def test_d_grads_match_jax(case):
    got, want = case["grads"]
    assert set(got) == set(want)
    worst = max((rel_err(got[k], want[k]), k) for k in got)
    assert worst[0] <= 2e-3, worst


def test_d_step_leaves_g_alone(case):
    """The fakes come from G under no_grad, and its w_avg stays."""
    assert all(g is None for g in case["g_grads"])
    got, want = case["w_avg"]
    np.testing.assert_array_equal(got, want)
