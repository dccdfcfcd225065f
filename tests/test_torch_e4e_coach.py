"""The port's e4e coach against the JAX package's, on the CPU, in f32.

Configuration: ``tests/test_e4e.py``'s (output 32, target 32, D lambda
0.1, delta-norm lambda 2e-4, progressive steps (0, 2)) with two refinement
iterations and LPIPS-alex at 0.8 (the JAX module's random weights). The
compared encoder step runs at stage 1 (step 2 of the schedule), so the
adversarial term sees two rows and one delta is regularised.
``noise_strength`` stays 0, so the two frameworks' different random noise
drops out. The port takes the JAX (params, state, d_params) through
``load_e4e_from_jax`` and the same numpy inputs; its real w's come from
the z that the JAX coach draws from its key.

Tolerances, with their reasons:
  * loss, logs, y_hat, the validation logs and ``_fake_w``'s codes: 1e-4
    of scale, from the forward through 50 IR-SE layers and the synthesis
    network (``test_torch_stage2.py`` holds the pSp coach to the same);
  * each encoder tensor's update: 2e-3 of that tensor's largest update,
    plus 1e-6 of the largest update of any tensor, plus 4 f32 ulps of the
    parameter, as ``test_torch_stage2.py`` (the update carries the
    gradient's summation differences through the whole network);
  * BatchNorm running statistics after the encoder step: 1e-4 of the
    layer's scale (a mean against the square root of its largest running
    variance, a variance against its largest): a running mean is a mean
    of activations that largely cancel, so its own largest value can be
    ~1e-4 of the activations it sums; across the D step: bit for bit
    (that pass updates copies);
  * the D step on given w's: loss 1e-5 relative; each gradient 2e-3 of
    its tensor's largest (R1 is a second derivative through four
    512-wide layers); Adam's first update is lr * g / (|g| + eps), about
    lr * sign(g), so updates are compared only where |g| > 1e-4, far
    above eps = 1e-8, at 1e-3 of lr;
  * the D step through the pools: loss 1e-4 relative (its fake w's carry
    the encoder's 1e-4); the pools' rows: real w's 1e-5 and fake w's 1e-4
    of scale, selected alike (their random draws do not depend on the
    data).

The inputs: at batch 2 a PReLU input within f32 rounding of 0 takes the
other branch in one framework now and then, and that moves the next
conv's weight gradient by a few per cent of its largest (ROADMAP §C, as
in stage 3). Over input seeds 11-16 and 31 of this test, measured against
a float64 run of the port's encoder and generator: at 11 and 16 the
port's f32 step flips (9.8 and 6.7 times the tolerance, the JAX step
agrees with float64 or with the port), at 12 and 31 JAX's (4.5 and 11.5
times), at 13-15 neither. The compared step takes seed 13, and
``test_encoder_step_matches_jax_at_other_seeds`` compares the loss and
every update at 14 and 15 as well, so no single input carries the
comparison; ``test_encoder_step_is_f32_round_off`` holds the port's f32
step at seed 31, where JAX's flips, against its float64 step at the same
tolerance.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.train.stage2_e4e import E4eCoach as JCoach
from stylegan_for_facerec_tpu.train.stage2_e4e import E4eConfig as JConfig
from stylegan_for_facerec_torch.train.stage2_e4e import E4eCoach, E4eConfig
from stylegan_for_facerec_torch.utils.convert import (load_e4e_from_jax,
                                                      load_from_jax)
from test_torch_stage2 import (_check_updates, _close_scaled, _lpips_pair,
                               _torch_sd)

CFG = dict(output_size=32, n_iters_per_batch=2, lpips_lambda=0.8,
           l2_lambda=1.0, target_size=32, compute_dtype="float32",
           w_discriminator_lambda=0.1, delta_norm_lambda=2e-4,
           progressive_steps=(0, 2))
STEP = 2                  # the schedule's step of the compared encoder step
SEED, FLIP_SEED = 13, 31  # input seeds: no flip; a flip on the JAX side
OTHER_SEEDS = (14, 15)    # more input seeds where neither side flips


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _d_grads_and_update(jc, d_params, d_opt, tc, real_w, fake_w, do_r1):
    """One D step on given w's in both frameworks from the same D."""
    want_loss, want_g = jax.value_and_grad(jc._d_loss)(
        d_params, jnp.asarray(real_w), jnp.asarray(fake_w), do_r1)
    want_new, _, _ = jc._jit_d_step(d_params, d_opt, jnp.asarray(real_w),
                                    jnp.asarray(fake_w), do_r1=do_r1)
    load_from_jax(tc.discriminator, d_params, {})
    tc.d_optimizer = torch.optim.Adam(tc.discriminator.parameters(),
                                      lr=tc.cfg.w_discriminator_lr,
                                      betas=(0.9, 0.999))
    before = {k: v.clone() for k, v in
              tc.discriminator.state_dict().items()}
    loss = tc.d_step(torch.from_numpy(real_w), torch.from_numpy(fake_w),
                     do_r1)
    as_np = lambda tree: {k: np.asarray(v) for k, v in _torch_named(
        tc.discriminator, tree).items()}
    return dict(loss=float(want_loss), t_loss=loss.item(),
                g=as_np(want_g), new=as_np(want_new),
                t_g={k: p.grad.numpy().copy() for k, p in
                     tc.discriminator.named_parameters()},
                before={k: v.numpy() for k, v in before.items()},
                t_new={k: v.detach().numpy().copy() for k, v in
                       tc.discriminator.state_dict().items()})


def _torch_named(disc, tree):
    """A JAX D tree ({"mlp": {"0": {"weight" (in, out), "bias"}}}) under
    the port's names and layouts."""
    from stylegan_for_facerec_torch.utils.convert import from_jax
    return {k: v.numpy() for k, v in from_jax(disc, tree, {}).items()}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2)]


def _port_step(tlp, params, state, d_params, avg, seed, dtype):
    """The state_dict and the loss after one port encoder step at stage 1,
    with the encoder and generator in ``dtype`` (D, LPIPS and the losses
    stay f32: the coach computes its losses on f32 outputs)."""
    tc = E4eCoach(E4eConfig(**CFG), lpips_fn=tlp, device="cpu")
    load_e4e_from_jax(tc, params, state, d_params)
    tc.set_stage(1)
    tc.model.to(dtype)
    x, y = _inputs(seed)
    loss, _, _ = tc.train_step(
        torch.from_numpy(x).to(dtype), torch.from_numpy(y),
        torch.from_numpy(np.asarray(avg)).to(dtype),
        torch.Generator().manual_seed(0))
    return ({k: v.detach().double().numpy() for k, v in
             tc.model.state_dict().items()}, loss.item())


@pytest.fixture(scope="module")
def run():
    jlp, tlp = _lpips_pair()
    jc = JCoach(JConfig(**CFG), lpips_fn=jlp)
    params, state, opt, d_params, d_opt = jc.init(jax.random.key(0))
    state = jc.estimate_latent_avg(params, state, jax.random.key(1),
                                   n_latent=64)
    avg = jc.make_avg_image(params, state, jax.random.key(2))
    stage = jc.stage_for_step(STEP)
    jc.set_stage(stage)
    tc = E4eCoach(E4eConfig(**CFG), lpips_fn=tlp, device="cpu")
    load_e4e_from_jax(tc, params, state, d_params)
    tc.set_stage(tc.stage_for_step(STEP))
    x, y = _inputs(SEED)
    xt, yt, avgt = (torch.from_numpy(np.asarray(a)) for a in (x, y, avg))
    out = {"stage": stage, "t_stage": tc.model.stage,
           "sd0": _torch_sd(jc, params, state), "tc": tc}

    # the port's f32 and float64 steps where JAX's f32 step flips
    out["f64"] = {name: _port_step(tlp, params, state, d_params, avg,
                                   FLIP_SEED, dt)[0]
                  for name, dt in (("f32", torch.float32),
                                   ("f64", torch.float64))}

    # the encoder step at the other inputs where neither side flips
    out["other"] = {}
    for seed in OTHER_SEEDS:
        xs, ys = _inputs(seed)
        p1, s1, _, loss, _, _, _ = jc.train_step(
            params, state, opt, jnp.asarray(xs), jnp.asarray(ys), avg,
            jax.random.key(3), d_params)
        t_sd, t_loss = _port_step(tlp, params, state, d_params, avg, seed,
                                  torch.float32)
        out["other"][seed] = dict(loss=float(loss), sd=_torch_sd(jc, p1, s1),
                                  t_loss=t_loss, t_sd=t_sd)

    # the encoder step
    params1, state1, _, loss, logs, y_hat, _ = jc.train_step(
        params, state, opt, jnp.asarray(x), jnp.asarray(y), avg,
        jax.random.key(3), d_params)
    noise = torch.Generator().manual_seed(0)
    t_loss, t_logs, t_yhat = tc.train_step(xt, yt, avgt, noise)
    out["enc"] = dict(
        loss=float(loss), logs={k: float(v) for k, v in logs.items()},
        y_hat=np.asarray(y_hat), sd=_torch_sd(jc, params1, state1),
        t_loss=t_loss.item(), t_logs={k: v.item() for k, v in
                                      t_logs.items()},
        t_yhat=t_yhat.numpy(),
        t_sd={k: v.detach().numpy().copy() for k, v in
              tc.model.state_dict().items()},
        d_grads=[p.grad for p in tc.discriminator.parameters()],
        d_requires_grad=[p.requires_grad
                         for p in tc.discriminator.parameters()])

    # validation, adversarial term included
    _, vlogs, _ = jc.validate_batch(params1, state1, jnp.asarray(x),
                                    jnp.asarray(y), avg, jax.random.key(5),
                                    d_params=d_params)
    _, t_vlogs, _ = tc.validate_batch(xt, yt, avgt, noise)
    out["val"] = ({k: float(v) for k, v in vlogs.items()},
                  {k: v.item() for k, v in t_vlogs.items()})

    # _fake_w: JAX, the port, and a direct train-mode pass of a copy
    bufs = {k: v.clone() for k, v in tc.model.encoder.named_buffers()}
    direct = copy.deepcopy(tc.model.encoder).train()
    x_in = torch.cat([xt.permute(0, 3, 1, 2),
                      avgt.permute(2, 0, 1)[None].expand(2, -1, -1, -1)], 1)
    with torch.no_grad():
        out["fake"] = dict(
            want=np.asarray(jc._jit_fake_w(params1, state1, jnp.asarray(x),
                                           avg)),
            got=tc._fake_w(xt, avgt).numpy(), direct=direct(x_in).numpy())
    out["fake"]["bufs_kept"] = all(
        torch.equal(bufs[k], v) for k, v in
        tc.model.encoder.named_buffers())

    # the D step through the pools, with R1 (step 0)
    key = jax.random.key(4)
    z = np.asarray(jax.random.normal(key, (2, 512)))
    _, _, d_loss = jc.train_discriminator(params1, state1, d_params, d_opt,
                                          jnp.asarray(x), avg, key, step=0)
    bufs = {k: v.clone() for k, v in tc.model.state_dict().items()}
    t_d_loss = tc.train_discriminator(xt, avgt, step=0,
                                      z=torch.from_numpy(z))
    out["dpipe"] = dict(
        loss=float(d_loss), t_loss=t_d_loss.item(),
        pools=[(np.stack(jp.ws), torch.stack(tp.ws).numpy())
               for jp, tp in ((jc.real_pool, tc.real_pool),
                              (jc.fake_pool, tc.fake_pool))],
        model_kept=all(torch.equal(bufs[k], v) for k, v in
                       tc.model.state_dict().items()))

    # one D step on given w's, with and without R1
    wr = np.random.RandomState(32)
    real_w = wr.randn(4, 512).astype(np.float32)
    fake_w = (0.5 * wr.randn(4, 512) + 0.2).astype(np.float32)
    out["dstep"] = {do_r1: _d_grads_and_update(jc, d_params, d_opt, tc,
                                               real_w, fake_w, do_r1)
                    for do_r1 in (True, False)}

    # stage 0: no active delta
    tc.set_stage(0)
    _, logs0, _ = tc.train_step(xt, yt, avgt, noise)
    out["stage0"] = ({k: v.item() for k, v in logs0.items()},
                     all(torch.isfinite(p).all()
                         for p in tc.model.encoder.parameters()))
    return out


def test_stage_schedule(run):
    assert run["stage"] == run["t_stage"] == 1


def test_encoder_step_matches_jax(run):
    r = run["enc"]
    np.testing.assert_allclose(r["t_loss"], r["loss"], rtol=1e-4)
    assert sorted(r["t_logs"]) == sorted(r["logs"]) == [
        "encoder_discriminator_loss", "loss", "loss_l2", "loss_lpips",
        "total_delta_loss"]
    for k, v in r["logs"].items():
        np.testing.assert_allclose(r["t_logs"][k], v, rtol=1e-4, err_msg=k)
    assert r["logs"]["total_delta_loss"] > 0
    _close_scaled(r["t_yhat"], r["y_hat"], 1e-4, "y_hat")
    n = _check_updates(run["sd0"], r["sd"], r["t_sd"], "encoder.")
    assert n == len(list(run["tc"].model.encoder.parameters()))
    for k, v in r["sd"].items():
        if k.endswith("running_var"):
            _close_scaled(r["t_sd"][k], v, 1e-4, k)
        elif k.endswith("running_mean"):
            spread = np.sqrt(np.abs(r["sd"][k[:-4] + "var"]).max())
            err = np.abs(r["t_sd"][k] - v).max()
            assert err <= 1e-4 * spread, (k, err, spread)


@pytest.mark.parametrize("seed", OTHER_SEEDS)
def test_encoder_step_matches_jax_at_other_seeds(run, seed):
    r = run["other"][seed]
    np.testing.assert_allclose(r["t_loss"], r["loss"], rtol=1e-4)
    n = _check_updates(run["sd0"], r["sd"], r["t_sd"], "encoder.")
    assert n == len(list(run["tc"].model.encoder.parameters()))


def test_encoder_step_is_f32_round_off(run):
    """At FLIP_SEED the port's f32 step agrees with its float64 step to the
    tolerance that holds it against JAX elsewhere."""
    r = run["f64"]
    n = _check_updates(run["sd0"], r["f64"], r["f32"], "encoder.")
    assert n == len(list(run["tc"].model.encoder.parameters()))


def test_encoder_step_leaves_d_and_decoder_alone(run):
    r = run["enc"]
    assert all(g is None for g in r["d_grads"])
    # D's parameters require grad again after the step, for the D step
    assert all(r["d_requires_grad"])
    for k, v in run["sd0"].items():
        if k.startswith("decoder."):
            np.testing.assert_array_equal(r["t_sd"][k], v, err_msg=k)


def test_validation_includes_the_adversarial_term(run):
    want, got = run["val"]
    assert sorted(got) == sorted(want)
    assert "encoder_discriminator_loss" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


def test_fake_w_is_a_raw_encoder_pass(run):
    """Raw codes of the first iteration's input, with batch statistics,
    and the running statistics untouched."""
    f = run["fake"]
    np.testing.assert_array_equal(f["got"], f["direct"])
    _close_scaled(f["got"], f["want"], 1e-4, "fake w")
    assert f["bufs_kept"]


def test_d_step_through_pools_matches_jax(run):
    r = run["dpipe"]
    np.testing.assert_allclose(r["t_loss"], r["loss"], rtol=1e-4)
    (jr, tr), (jf, tf) = r["pools"]
    assert tr.shape == jr.shape == (2, 512)
    assert tf.shape == jf.shape == (2, 512)
    _close_scaled(tr, jr, 1e-5, "real pool")
    _close_scaled(tf, jf, 1e-4, "fake pool")
    # the D step moves neither the encoder's statistics nor w_avg
    assert r["model_kept"]


@pytest.mark.parametrize("do_r1", [True, False])
def test_d_step_matches_jax(run, do_r1):
    r = run["dstep"][do_r1]
    np.testing.assert_allclose(r["t_loss"], r["loss"], rtol=1e-5)
    lr = run["tc"].cfg.w_discriminator_lr
    for k, g in r["g"].items():
        tol = 2e-3 * np.abs(g).max()
        assert np.abs(r["t_g"][k] - g).max() <= tol, k
        big = np.abs(g) > 1e-4
        assert big.mean() > 0.5, k
        want_u = (r["new"][k] - r["before"][k])[big]
        got_u = (r["t_new"][k] - r["before"][k])[big]
        assert np.abs(got_u - want_u).max() <= 1e-3 * lr, k


def test_r1_changes_the_d_loss(run):
    assert run["dstep"][True]["loss"] > run["dstep"][False]["loss"]
    np.testing.assert_allclose(run["dstep"][True]["t_loss"],
                               run["dstep"][True]["loss"], rtol=1e-5)


def test_stage0_delta_loss_is_exactly_zero(run):
    logs, finite = run["stage0"]
    assert logs["total_delta_loss"] == 0.0
    assert np.isfinite(logs["loss"]) and finite
