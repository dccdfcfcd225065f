"""The port's Ranger against the JAX package's ``optim.ranger`` (optax), on
the CPU, over 8 steps: past the RAdam threshold (rho_t >= 5 from step 6)
and through the Lookahead sync at step 6.

Parameters: a 4-D conv weight (HWIO in JAX, OIHW in the port), a 2-D dense
weight ((out, in) in both) and a 1-D bias, with per-step gradients drawn
by numpy and handed to both. Tolerance: 1e-6 of each tensor's largest
total change plus one f32 ulp of the parameter per step. The two take the same
steps in float32 (the port computes the step constants as optax does) and
differ only in the order of the centralisation's mean and in the rounding
of p + u, one f32 rounding per step, so up to one ulp per step taken.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.train import optim as joptim
from stylegan_for_facerec_torch.train.optim import Ranger, radam_constants

STEPS = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores, and
    torch's thread pool contending with them slows small kernels by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rng):
    return {"conv": (rng.randn(3, 3, 4, 5) * 0.1).astype(np.float32),
            "dense": (rng.randn(6, 7) * 0.1).astype(np.float32),
            "bias": (rng.randn(6) * 0.1).astype(np.float32)}


def _to_port(name, a):
    return np.transpose(a, (3, 2, 0, 1)) if name == "conv" else a


@pytest.mark.parametrize("lr", [1e-4, 1e-2])
def test_ranger_matches_optax(lr):
    rng = np.random.RandomState(0)
    p0 = _params(rng)
    grads = [{k: (rng.randn(*v.shape) * 10 ** rng.uniform(-3, 0)).astype(
        np.float32) for k, v in p0.items()} for _ in range(STEPS)]

    tx = joptim.ranger(lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(
        np.ascontiguousarray(_to_port(k, v)))) for k, v in p0.items()}
    opt = Ranger(tp.values(), lr=lr)

    for step, g in enumerate(grads, start=1):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in
                                        g.items()}, opt_state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(np.ascontiguousarray(_to_port(k, g[k])))
        opt.step()
        for k in p0:
            want = _to_port(k, np.asarray(jp[k]))
            got = tp[k].detach().numpy()
            change = np.abs(want - _to_port(k, p0[k])).max()
            tol = 1e-6 * change + step * np.spacing(np.abs(want))
            assert np.all(np.abs(got - want) <= tol), (step, k)
    assert opt.state[tp["conv"]]["step"] == STEPS


def test_radam_threshold_and_lookahead_cross_in_the_window():
    """The window exercises both branches of RAdam and the sync."""
    rect = [radam_constants(t, 0.95, 0.999)[2] is not None
            for t in range(1, STEPS + 1)]
    assert rect == [False] * 5 + [True] * 3
    assert 6 <= STEPS


def test_ranger_skips_params_without_grad():
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(3))
    opt = Ranger([a, b], lr=0.1)
    a.grad = torch.ones(3)
    opt.step()
    assert not torch.equal(a.detach(), torch.ones(3))
    assert torch.equal(b.detach(), torch.ones(3)) and b not in opt.state
