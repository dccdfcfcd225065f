"""The port's stage-1 G loss against the JAX package's
``Stage1Trainer._g_loss``, on the CPU in f32, without and with lazy path
length.

Configuration as ``test_torch_stage1_dstep.py``: 32 px, batch 4, JAX init
weights with noise_strength, ``w_avg`` and ``pl_mean`` (0.3) set away
from 0, ADA at p = 0.5. Both sides take the same draws: z, the layer noise
(k1), the fakes' ADA parameters (k2), and for path length the layer noise
``fold_in(k3, i)`` of the synthesis run on the first half of z and the
projection ``normal(k3, img.shape) / sqrt(H W)``.

Tolerances: loss, plp and pl_new 1e-4 relative, the new ``w_avg`` 1e-5 of
its largest; without path length each G gradient within 2e-3 of that
tensor's largest element. With path length, the penalty's gradient is a
second derivative summed over every pixel against a random-sign
projection, and f32 round-off of those sums sets the agreement: the port
and the JAX package each differ from a float64 run of the port by up to
4.6e-3 of a tensor's largest element (1.9e-3 of its norm; held by
``test_g_grads_are_f32_round_off``), while detaching pl_new (a change
of semantics: pl_new moves with the mean length at 0.01) would move the
gradients by about 1 % of their norm. So with path length each gradient
is held within 1e-2 of its largest element and 2e-3 of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stage1_parity import (g_draws, jax_trainer_and_state, port_trainer,
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
    fn = jax.jit(jax.value_and_grad(jt._g_loss, has_aux=True),
                 static_argnames=("do_plp",))
    return jt, st, fn


def _double(obj):
    if isinstance(obj, dict):
        return {k: _double(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_double(v) for v in obj]
    return obj.double() if obj.is_floating_point() else obj


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "plp"])
def case(request, tmp_path_factory):
    """One G loss's comparison, computed once a session (the JAX loss's
    compile with path length takes a minute and more)."""
    return shared_result(
        tmp_path_factory, f"stage1_gstep_{request.param}",
        lambda: _case(request.getfixturevalue("jax_side"), request.param))


def _case(jax_side, do_plp):
    _, st, fn = jax_side
    z = np.random.RandomState(2).randn(4, 512).astype(np.float32)
    rng = jax.random.key(6)
    (loss, (gs, pl_new, plp)), grads = fn(
        st["g"], st["d"], st["g_state"], jnp.asarray(z), st["ada_p"],
        st["pl_mean"], rng, do_plp=do_plp)
    tr = port_trainer(st)
    draws = g_draws(rng, z)
    p_loss, p_plp, p_pl_new = tr.g_loss(draws, do_plp)
    p_loss.backward()
    gs = jax.tree_util.tree_map(np.asarray, gs)
    want = from_jax(tr.G, jax.tree_util.tree_map(np.asarray, grads), gs)
    # the port in float64 (ADA still rounds to f32 inside, as the JAX
    # package's does): the reference for the round-off of both
    t64 = port_trainer(st)
    t64.G.double()
    t64.D.double()
    t64.pl_mean = t64.pl_mean.double()
    loss64, _, _ = t64.g_loss(_double(draws), do_plp)
    loss64.backward()
    f64 = {n: p.grad.numpy() for n, p in t64.G.named_parameters()}
    return {"do_plp": do_plp, "f64": f64,
            "scalars": {"loss": (p_loss.item(), float(loss)),
                        "plp": (p_plp.item(), float(plp)),
                        "pl_new": (p_pl_new.item(), float(pl_new))},
            "w_avg": (tr.G.mapping.w_avg.numpy(), gs["mapping"]["w_avg"]),
            "grads": ({n: p.grad.numpy() for n, p in tr.G.named_parameters()},
                      want)}


@pytest.mark.parametrize("name", ["loss", "plp", "pl_new"])
def test_g_scalars_match_jax(case, name):
    got, want = case["scalars"][name]
    assert abs(got - want) <= 1e-4 * max(abs(want), 1e-6), (name, got, want)


def test_g_w_avg_update_matches_jax(case):
    got, want = case["w_avg"]
    assert rel_err(got, want) <= 1e-5


def test_g_grads_match_jax(case):
    got, want = case["grads"]
    assert set(got) <= set(want)    # want also holds the buffers
    tol = 1e-2 if case["do_plp"] else 2e-3
    worst = max((rel_err(got[k], want[k]), k) for k in got)
    assert worst[0] <= tol, worst
    if case["do_plp"]:
        norm = max((np.linalg.norm(got[k] - np.asarray(want[k]))
                    / np.linalg.norm(want[k]), k) for k in got)
        assert norm[0] <= 2e-3, norm


def test_g_grads_are_f32_round_off(case):
    """The port's and the JAX package's f32 gradients each stay within
    1e-2 of each tensor's largest element of the port's float64
    gradients, and within 3e-3 of its norm: with path length the gap
    between them is round-off on both sides. Prints the measured spread
    (``-s``)."""
    got, want = case["grads"]
    f64 = case["f64"]
    spread = {}
    for name, g in (("port", got), ("jax", want)):
        el = max((rel_err(g[k], f64[k]), k) for k in f64)
        nm = max((float(np.linalg.norm(np.asarray(g[k]) - f64[k])
                        / np.linalg.norm(f64[k])), k) for k in f64)
        spread[name] = (el, nm)
        assert el[0] <= 1e-2 and nm[0] <= 3e-3, (name, el, nm)
    print(f"\nf32 G gradients (path length {case['do_plp']}) against the "
          f"port's float64: {spread}")
