"""The port's stage-2 coach against the JAX package's, on the CPU, in f32.

Configuration: ``tests/test_stage2_coach.py``'s (output 32, two
refinement iterations, target 32, w_norm 0.01, f32) plus LPIPS-alex at 0.8
with the JAX module's random weights. ``noise_strength`` stays 0, so the
two frameworks' different random noise drops out. The port takes the JAX
weights through ``load_from_jax`` and the same numpy inputs.

Tolerances, with their reasons:
  * loss, logs and y_hat: 1e-4 of scale. The forward passes through 50
    IR-SE layers and the synthesis network with convolutions summed in
    another order than XLA's (``test_torch_models.py`` holds the forward
    to 1e-4 as well).
  * each trained tensor's update (new - old): 2e-3 of that tensor's
    largest update, plus 1e-6 of the largest update of any tensor (for
    gradients that are zero by construction and come out as round-off),
    plus 4 f32 ulps of the parameter. The update is
    -lr * (centralised) gradient and carries the gradient's summation
    differences through the whole network and back; p + u is rounded in
    f32 once per framework and step.
  * BatchNorm running statistics: 1e-4 of scale (from the forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.losses import perceptual as jperc
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.train import Stage2Coach as JCoach
from stylegan_for_facerec_tpu.train import Stage2Config as JConfig
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch.losses import LPIPS
from stylegan_for_facerec_torch.train import Stage2Coach, Stage2Config
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax
from torch_mp_shared import shared_result

CFG = dict(output_size=32, n_iters_per_batch=2, lpips_lambda=0.8,
           l2_lambda=1.0, w_norm_lambda=0.01, target_size=32,
           compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores, and
    torch's thread pool contending with them slows small kernels by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lpips_pair():
    jm = jperc.LPIPS("alex")
    lpp, lps = jm.init(jax.random.key(5))
    tm = LPIPS("alex")
    tm.load_state_dict(from_jax(tm, lpp, lps), strict=True)
    return (lambda a, b: jm.apply(lpp, {}, (a, b), Ctx())[0],
            tm.requires_grad_(False))


def _torch_sd(jcoach, params, state):
    """The JAX trees as the port's state_dict, keyed like it."""
    return {k: np.asarray(v) for k, v in
            to_torch(jcoach.model, params, state).items()}


def _run(cfg_kw, steps, seed):
    jlp, tlp = _lpips_pair()
    jc = JCoach(JConfig(**cfg_kw), lpips_fn=jlp)
    params, state, opt = jc.init(jax.random.key(0))
    state = jc.estimate_latent_avg(params, state, jax.random.key(1),
                                   n_latent=64)
    avg = jc.make_avg_image(params, state, jax.random.key(2))
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)

    tc = Stage2Coach(Stage2Config(**cfg_kw), lpips_fn=tlp, device="cpu")
    load_from_jax(tc.model, params, state)
    out = {"sd0": _torch_sd(jc, params, state), "avg": np.asarray(avg),
           "t_avg": tc.make_avg_image().numpy(), "steps": [], "tc": tc}
    noise = torch.Generator().manual_seed(0)
    for i in range(steps):
        params, state, opt, loss, logs, y_hat = jc.train_step(
            params, state, opt, jnp.asarray(x), jnp.asarray(y), avg,
            jax.random.key(3 + i))
        t_loss, t_logs, t_yhat = tc.train_step(
            torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(np.asarray(avg)), noise)
        out["steps"].append(dict(
            loss=float(loss), logs={k: float(v) for k, v in logs.items()},
            y_hat=np.asarray(y_hat), sd=_torch_sd(jc, params, state),
            t_loss=t_loss.item(), t_logs={k: v.item() for k, v in
                                          t_logs.items()},
            t_yhat=t_yhat.numpy(),
            t_sd={k: v.detach().numpy().copy() for k, v in
                  tc.model.state_dict().items()}))
    return out


def _reduced(cfg_kw, steps, seed):
    """``_run``'s comparisons, each reduced to what its test asserts on
    (the whole state dicts are ~0.5 GB each): per step the update ratios
    of ``_update_ratios``, each BatchNorm running statistic (port, JAX,
    before), the decoder tensors that moved; and the coach's end state,
    which rebuilds it."""
    out = _run(cfg_kw, steps, seed)
    tc, sd0 = out.pop("tc"), out.pop("sd0")
    for r in out["steps"]:
        want_sd, got_sd = r.pop("sd"), r.pop("t_sd")
        r["updates"] = _update_ratios(sd0, want_sd, got_sd, "encoder.")
        r["running"] = {k: (got_sd[k], v, sd0[k]) for k, v in want_sd.items()
                        if k.endswith(("running_mean", "running_var"))}
        r["decoder_moved"] = [k for k, v in sd0.items()
                              if k.startswith("decoder.") and not
                              np.array_equal(got_sd[k], v, equal_nan=True)]
    out["coach"] = {"model": tc.model.state_dict(),
                    "latent_avg": tc.model.latent_avg.clone(),
                    "lpips": tc.lpips_fn.state_dict()}
    return out


@pytest.fixture(scope="module")
def frozen_decoder(tmp_path_factory):
    """Two coach steps against JAX's, computed once a session (the JAX
    train step's compile reaches ~15 GB); the coach is rebuilt here from
    its end state."""
    out = shared_result(tmp_path_factory, "stage2_frozen_decoder",
                        lambda: _reduced(CFG, steps=2, seed=11))
    saved = out.pop("coach")
    tlp = LPIPS("alex")
    tlp.load_state_dict(saved["lpips"], strict=True)
    tc = Stage2Coach(Stage2Config(**CFG), lpips_fn=tlp.requires_grad_(False),
                     device="cpu")
    tc.model.load_state_dict(saved["model"], strict=True)
    tc.model.latent_avg.copy_(saved["latent_avg"])
    out["tc"] = tc
    return out


def _close_scaled(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} * {scale:.3e}"


def _update_ratios(sd0, want_sd, got_sd, prefix, skip=()):
    """(each tensor's largest update difference over its tolerance, its
    key; largest first) and the number of tensors compared."""
    keys = [k for k in sd0 if k.startswith(prefix) and k not in skip
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]
    # a gradient that is zero by construction (a per-channel shift that the
    # next train-mode BatchNorm removes) comes out as f32 round-off of its
    # cancelling terms: 1e-6 of the largest update of any tensor covers it
    floor = 1e-6 * max(np.abs(want_sd[k] - sd0[k]).max() for k in keys)
    worst = []
    for k in keys:
        want_u = want_sd[k] - sd0[k]
        got_u = got_sd[k] - sd0[k]
        tol = (2e-3 * np.abs(want_u).max() + floor
               + 4 * np.spacing(np.abs(want_sd[k]).astype(np.float32)))
        worst.append((float((np.abs(got_u - want_u) / tol).max()), k))
    worst.sort(reverse=True)
    return worst, len(keys)


def _check_updates(sd0, want_sd, got_sd, prefix, skip=()):
    worst, n = _update_ratios(sd0, want_sd, got_sd, prefix, skip)
    assert worst[0][0] <= 1.0, worst[:5]
    return n


def test_avg_image_matches_jax(frozen_decoder):
    _close_scaled(frozen_decoder["t_avg"], frozen_decoder["avg"], 1e-4,
                  "avg_image")
    assert frozen_decoder["t_avg"].shape == (32, 32, 3)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_matches_jax(frozen_decoder, step):
    r = frozen_decoder["steps"][step]
    np.testing.assert_allclose(r["t_loss"], r["loss"], rtol=1e-4)
    assert sorted(r["t_logs"]) == sorted(r["logs"]) == [
        "loss", "loss_l2", "loss_lpips", "loss_w_norm"]
    for k, v in r["logs"].items():
        np.testing.assert_allclose(r["t_logs"][k], v, rtol=1e-4, err_msg=k)
    _close_scaled(r["t_yhat"], r["y_hat"], 1e-4, "y_hat")
    worst, n = r["updates"]
    assert worst[0][0] <= 1.0, worst[:5]
    # every encoder parameter, BatchNorm affine and PReLU included
    assert n == len(list(frozen_decoder["tc"].model.encoder.parameters()))
    for k, (got, want, before) in r["running"].items():
        _close_scaled(got, want, 1e-4, k)
        assert not np.array_equal(want, before), k


def test_decoder_stays_frozen(frozen_decoder):
    for r in frozen_decoder["steps"]:
        assert r["decoder_moved"] == [], r["decoder_moved"][:5]
    tc = frozen_decoder["tc"]
    assert not any(p.requires_grad for p in tc.model.decoder.parameters())
    assert all(p.requires_grad for p in tc.model.encoder.parameters())


def test_validate_runs_eval_mode_and_averages(frozen_decoder):
    """``validate``: BatchNorm in eval mode (no statistic moves), the mean
    of ``validate_batch``'s logs, ``max_batches`` honoured, and the model
    left in train mode."""
    tc = frozen_decoder["tc"]
    rng = np.random.RandomState(13)
    batches = [tuple(torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3))
                                      .astype(np.float32)) for _ in range(2))
               for _ in range(3)]
    avg = torch.from_numpy(frozen_decoder["avg"])
    before = {k: v.clone() for k, v in tc.model.state_dict().items()}
    noise = torch.Generator().manual_seed(1)
    logs = tc.validate(iter(batches), avg, noise, max_batches=2)
    each = [float(tc.validate_batch(x, y, avg, noise)[1]["loss"])
            for x, y in batches[:2]]
    assert logs["loss"] == pytest.approx(np.mean(each), rel=1e-6)
    for k, v in tc.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tc.model.training
