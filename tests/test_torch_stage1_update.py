"""The port's stage-1 trainer outside its losses, on the CPU: Adam (0,
0.99) on given gradients against optax, the ADA controller against the
JAX trainer's ``update_ada``, g_ema, the step schedule, that D takes no
gradient in the G step, and the state_dict round trip."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylegan_for_facerec_tpu.train.stage1 import Stage1Trainer as JTrainer
from stylegan_for_facerec_tpu.utils.config import Stage1Config as JConfig
from stylegan_for_facerec_torch.train.stage1 import Stage1Trainer
from stylegan_for_facerec_torch.utils.config import Stage1Config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainer():
    return Stage1Trainer(Stage1Config(image_size=32, batch_size=4),
                         device="cpu")


def test_adam_matches_optax():
    """Three updates of torch.optim.Adam(betas=(0, 0.99), eps=1e-8), as the
    trainer builds it, against optax.adam on the same gradients: within
    1e-6 of each update's largest (the same formula, rounded in another
    order)."""
    rs = np.random.RandomState(0)
    p0 = rs.randn(5, 7).astype(np.float32)
    grads = [rs.randn(5, 7).astype(np.float32) * s for s in (1.0, 0.1, 3.0)]
    tx = optax.adam(0.002, b1=0.0, b2=0.99, eps=1e-8)
    pj = jnp.asarray(p0)
    opt_state = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([pt], lr=0.002, betas=(0.0, 0.99), eps=1e-8)
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, pj)
        pj = pj + upd
        before = pt.detach().clone()
        pt.grad = torch.from_numpy(g)
        opt.step()
        u_t = (pt.detach() - before).numpy()
        np.testing.assert_allclose(u_t, np.asarray(upd), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(upd)).max()
                                   + 4e-7 * np.abs(p0).max())


@pytest.mark.parametrize("rt_sum,count", [(2.9, 4.0), (1.2, 4.0), (0.0, 0.0),
                                          (-3.0, 4.0)])
def test_update_ada_matches_jax(trainer, rt_sum, count):
    jt = JTrainer(JConfig(image_size=32, batch_size=4))
    for p0 in (0.0, 0.3, 0.999):
        state = {"ada_p": jnp.asarray(p0, jnp.float32),
                 "rt_accum": jnp.asarray(rt_sum, jnp.float32),
                 "rt_count": jnp.asarray(count, jnp.float32)}
        want = jt.update_ada(state, 4 * 4)
        trainer.ada_p = torch.tensor(p0)
        trainer.rt_accum = torch.tensor(rt_sum)
        trainer.rt_count = torch.tensor(count)
        trainer.update_ada(4 * 4)
        assert trainer.ada_p.item() == float(want["ada_p"]), (p0, rt_sum)
        assert trainer.rt_accum.item() == 0 and trainer.rt_count.item() == 0


def test_schedule_matches_the_recipe(trainer):
    sched = [trainer.schedule(s) for s in range(17)]
    assert [s for s, (r1, _, _) in enumerate(sched) if r1] == [0, 16]
    assert [s for s, (_, plp, _) in enumerate(sched) if plp] == \
        [0, 4, 8, 12, 16]
    assert [s for s, (_, _, tick) in enumerate(sched) if tick] == \
        [4, 8, 12, 16]


def test_train_steps_move_g_d_ema_and_state(trainer):
    """Steps 0 (R1 + path length) and 1 (neither): finite logs; G, D and
    g_ema move; D takes no gradient in the G step; w_avg moves only in
    the G step; pl_mean on the path-length step; g_ema carries G's
    buffers; the state_dict round trip restores everything."""
    torch.manual_seed(0)
    reals = torch.rand(4, 32, 32, 3) * 2 - 1
    g0 = {k: v.clone() for k, v in trainer.G.state_dict().items()}
    d0 = {k: v.clone() for k, v in trainer.D.state_dict().items()}
    e0 = {k: v.clone() for k, v in trainer.g_ema.state_dict().items()}
    trainer.step = 0
    trainer.pl_mean = torch.zeros(())
    do_r1, do_plp, _ = trainer.schedule(0)
    d_draws, g_draws = trainer.draw(4, do_plp)
    w_avg0 = trainer.G.mapping.w_avg.clone()
    logs = trainer.d_step(reals, d_draws, do_r1)
    assert torch.equal(trainer.G.mapping.w_avg, w_avg0)
    logs.update(trainer.g_step(g_draws, do_plp))
    assert all(p.requires_grad for p in trainer.D.parameters())
    assert not torch.equal(trainer.G.mapping.w_avg, w_avg0)
    pl1 = trainer.pl_mean.clone()
    assert pl1.item() != 0.0 and logs["plp"].item() > 0
    logs2 = trainer.train_step(reals, step=1)
    assert trainer.step == 2 and torch.equal(trainer.pl_mean, pl1)
    for v in list(logs.values()) + list(logs2.values()):
        assert torch.isfinite(v).all()
    for before, mod in ((g0, trainer.G), (d0, trainer.D),
                        (e0, trainer.g_ema)):
        after = mod.state_dict()
        moved = [k for k in before if not torch.equal(before[k], after[k])]
        assert len(moved) > len(before) // 2
    assert torch.equal(trainer.g_ema.mapping.w_avg, trainer.G.mapping.w_avg)
    sd = trainer.state_dict()
    fresh = Stage1Trainer(Stage1Config(image_size=32, batch_size=4),
                          device="cpu", seed=9)
    fresh.load_state_dict(sd)
    for a, b in ((fresh.G, trainer.G), (fresh.D, trainer.D),
                 (fresh.g_ema, trainer.g_ema)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert fresh.step == 2 and torch.equal(fresh.pl_mean, trainer.pl_mean)
    assert fresh.opt_g.state_dict()["state"].keys() == \
        trainer.opt_g.state_dict()["state"].keys()


def test_d_takes_no_gradient_in_the_g_step(trainer):
    _, g_draws = trainer.draw(4, False)
    for p in trainer.D.parameters():
        p.grad = None
    trainer.g_step(g_draws, False)
    assert all(p.grad is None for p in trainer.D.parameters())
    assert all(p.requires_grad for p in trainer.D.parameters())


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from stylegan_for_facerec_torch.tools import train_stage1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stage1Trainer(Stage1Config(image_size=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_stage1.main(["--data_root", ".", "--exp_dir", "unused"])
