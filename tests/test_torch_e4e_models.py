"""The port's e4e modules against the JAX package, on the CPU, in f32.

Each test builds the JAX module, gives its BatchNorm running statistics,
biases and noise strengths seeded non-trivial values (``perturbed``),
carries the weights across with ``from_jax`` (strict) and runs both on
the same numpy inputs. Sizes follow ``tests/test_e4e.py``: 32 px inputs,
4-10 styles.

Tolerances, with their reasons:
  * encoder codes and e4e images: 1e-4 of the output's largest magnitude.
    The full IR-SE-50 body sums its convolutions in another order than
    XLA (``test_torch_models.py`` holds the pSp encoder to 1e-4 as well);
  * the latent discriminator (four 512-wide linears) and its R1 gradient:
    1e-5 of scale, sums of 512 products in another order;
  * the replay pools: bit for bit. They only select and move rows, with
    the same ``random.Random`` call sequence;
  * ``from_jax``: key for key and bit for bit against the JAX package's
    ``to_torch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.eval import inference as jinf
from stylegan_for_facerec_tpu.models import e4e as je4e
from stylegan_for_facerec_tpu.models import psp as jpsp
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch.eval.inference import encoder_bootstrap
from stylegan_for_facerec_torch.models import e4e, psp
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.train.stage2_e4e import E4eCoach, E4eConfig
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax
from test_torch_models import assert_close_scaled, nchw, nhwc, perturbed

CTX = Ctx(train=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prog_pair():
    """A JAX ProgressiveBackboneEncoder (full IR-SE-50, 4 styles of spatial
    2 for 32 px input) and the port's, with the same weights."""
    jm = je4e.ProgressiveBackboneEncoder(50, "ir_se", n_styles=4,
                                         input_nc=6, style_spatial=2)
    params, state = perturbed(jm, 20)
    tm = e4e.ProgressiveBackboneEncoder(50, "ir_se", n_styles=4, input_nc=6,
                                        style_spatial=2)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    return jm, params, state, tm.eval()


@pytest.mark.parametrize("stage", [0, 2, 18])
def test_progressive_encoder_matches_jax(prog_pair, stage):
    """Stages 0, 2 and 18: w0 broadcast, deltas on rows 1..min(stage, 3)."""
    jm, params, state, tm = prog_pair
    x = np.random.RandomState(21).randn(2, 32, 32, 6).astype(np.float32)
    want, _ = jm.set_stage(stage).apply(params, state, jnp.asarray(x), CTX)
    tm.set_stage(stage)
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    assert got.shape == (2, 4, 512)
    assert_close_scaled(got, np.asarray(want), 1e-4)
    for i in range(1, 4):
        same = np.array_equal(got[:, i], got[:, 0])
        assert same == (i > min(stage, 3)), (stage, i)


def test_progressive_encoder_train_mode_matches_jax(prog_pair):
    """Train-mode BatchNorm: the codes and the new running statistics."""
    jm, params, state, tm = prog_pair
    x = np.random.RandomState(22).randn(2, 32, 32, 6).astype(np.float32)
    want, new_state = jm.set_stage(2).apply(params, state, jnp.asarray(x),
                                            Ctx(train=True))
    tm = e4e.ProgressiveBackboneEncoder(50, "ir_se", n_styles=4, input_nc=6,
                                        style_spatial=2, stage=2)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    with torch.no_grad():
        got = tm.train()(nchw(x)).numpy()
    assert_close_scaled(got, np.asarray(want), 1e-4)
    want_sd = {k: np.asarray(v) for k, v in
               to_torch(jm, params, new_state).items()}
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert_close_scaled(v.numpy(), want_sd[k], 1e-4)


@pytest.fixture(scope="module")
def e4e_pair():
    """JAX E4e(32, input 32) and the port's, with the same weights and a
    seeded latent_avg."""
    jm = je4e.E4e(output_size=32, input_size=32)
    params, state = perturbed(jm, 23)
    state["latent_avg"] = (0.1 * np.random.RandomState(24).randn(
        jm.n_styles, 512)).astype(np.float32)
    tm = load_from_jax(e4e.E4e(output_size=32, input_size=32), params,
                       state).eval()
    return jm, params, state, tm


def test_e4e_from_jax_equals_to_torch(e4e_pair):
    jm, params, state, tm = e4e_pair
    want = to_torch(jm, params, state)
    got = from_jax(tm, params, state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    tm.load_state_dict(got, strict=True)
    # the progressive encoder keeps BackboneEncoder's parameter names, so
    # an e4e state_dict loads into a PSp
    psp.PSp(output_size=32, input_size=32).load_state_dict(got, strict=True)


@pytest.mark.parametrize("stage", [1, 18])
def test_e4e_forward_matches_jax(e4e_pair, stage):
    """Images and codes, from latent_avg and from a carried latent."""
    jm, params, state, tm = e4e_pair
    rng = np.random.RandomState(25)
    x = rng.randn(2, 32, 32, 6).astype(np.float32)
    latent = (0.1 * rng.randn(2, jm.n_styles, 512)).astype(np.float32)
    jstage = jm.set_stage(stage)
    tm.set_stage(stage)
    assert tm.stage == stage and tm.encoder.stage == stage
    for lat in (None, latent):
        (want_img, want_codes), _ = jstage.apply(
            params, state, (jnp.asarray(x), None if lat is None
                            else jnp.asarray(lat)), CTX,
            randomize_noise=False, return_latents=True)
        with torch.no_grad():
            img, codes = tm(nchw(x), None if lat is None
                            else torch.from_numpy(lat),
                            randomize_noise=False, return_latents=True)
        assert img.shape == (2, 3, 256, 256)
        assert_close_scaled(codes.numpy(), np.asarray(want_codes), 1e-4)
        assert_close_scaled(nhwc(img), np.asarray(want_img), 1e-4)


def test_set_stage_is_in_place():
    m = e4e.E4e(output_size=32, input_size=32)
    params = list(m.parameters())
    assert m.stage == e4e.PROGRESSIVE_STAGE_INFERENCE
    assert m.set_stage(3) is m and m.encoder.stage == 3
    assert all(a is b for a, b in zip(params, m.parameters()))
    assert isinstance(m.encoder, e4e.ProgressiveBackboneEncoder)
    assert type(psp.PSp(output_size=32).encoder) is psp.BackboneEncoder


def test_encoder_bootstrap_matches_jax(e4e_pair):
    """An E4e (stage 18) makes the first inversion, a PSp runs the other
    two iterations."""
    jm1, p1, s1, tm1 = e4e_pair
    jm2 = jpsp.PSp(output_size=32, input_size=32)
    p2, s2 = perturbed(jm2, 26)
    s2["latent_avg"] = np.zeros((jm2.n_styles, 512), np.float32)
    tm2 = load_from_jax(psp.PSp(output_size=32, input_size=32), p2,
                        s2).eval()
    tm1.set_stage(18)
    rng = np.random.RandomState(27)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    avg = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    want_o, want_l = jinf.encoder_bootstrap(
        jm1.set_stage(18), (p1, s1), jm2, (p2, s2), jnp.asarray(x),
        jnp.asarray(avg), n_iters=3)
    outs, lats = encoder_bootstrap(tm1, tm2, torch.from_numpy(x),
                                   torch.from_numpy(avg), n_iters=3)
    assert outs.shape == (3, 2, 256, 256, 3)
    assert lats.shape == (3, 2, jm1.n_styles, 512)
    for it in range(3):
        assert_close_scaled(outs[it].numpy(), np.asarray(want_o[it]), 1e-4)
        assert_close_scaled(lats[it].numpy(), np.asarray(want_l[it]), 1e-4)
    with pytest.raises(ValueError, match="eval mode"):
        encoder_bootstrap(tm1.train(), tm2, torch.from_numpy(x),
                          torch.from_numpy(avg), n_iters=2)
    tm1.eval()


@pytest.fixture(scope="module")
def disc_pair():
    jm = je4e.LatentCodesDiscriminator(512, 4)
    params, _ = perturbed(jm, 28)
    tm = e4e.LatentCodesDiscriminator(512, 4)
    tm.load_state_dict(from_jax(tm, params, {}), strict=True)
    return jm, params, tm


def test_latent_discriminator_from_jax_equals_to_torch(disc_pair):
    jm, params, tm = disc_pair
    want = to_torch(jm, params, {})
    got = from_jax(tm, params, {})
    assert sorted(got) == sorted(want) == sorted(tm.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_latent_discriminator_and_r1_grad_match_jax(disc_pair):
    """D(w) and the R1 gradient d(sum D(w))/dw."""
    jm, params, tm = disc_pair
    w = np.random.RandomState(29).randn(6, 512).astype(np.float32)
    want, _ = jm.apply(params, {}, jnp.asarray(w), Ctx(train=True))
    want_g = jax.grad(lambda v: jnp.sum(
        jm.apply(params, {}, v, Ctx(train=True))[0]))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tm(wt)
    got_g, = torch.autograd.grad(got.sum(), wt)
    assert got.shape == (6, 1)
    assert_close_scaled(got.detach().numpy(), np.asarray(want), 1e-5)
    assert_close_scaled(got_g.numpy(), np.asarray(want_g), 1e-5)


def test_latent_discriminator_init_is_torch_default():
    """Kaiming-uniform (a = sqrt 5) weights and fan-in biases, drawn from
    the generator: bounds 1 / sqrt(fan_in), the same seed the same D."""
    a, b = (init_weights(e4e.LatentCodesDiscriminator(),
                         torch.Generator().manual_seed(5)) for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
        bound = 1 / np.sqrt(512)
        assert float(va.abs().max()) <= bound, k
        if va.numel() >= 100:
            assert float(va.abs().max()) > 0.9 * bound, k
    assert [type(m).__name__ for m in a.mlp] == [
        "Linear", "LeakyReLU"] * 3 + ["Linear"]
    assert all(m.negative_slope == 0.2 for m in a.mlp[1::2])


def _pool_queries():
    rng = np.random.RandomState(30)
    shapes = [(4, 512), (3, 5, 512), (6, 512), (4, 7, 512), (5, 512),
              (2, 3, 512), (8, 512), (6, 2, 512)]
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("pool_size", [0, 3, 50])
def test_latent_codes_pool_matches_jax(pool_size):
    """A sequence of 2-D and 3-D queries: the same rows, bit for bit."""
    jpool = je4e.LatentCodesPool(pool_size, seed=1)
    tpool = e4e.LatentCodesPool(pool_size, seed=1)
    for q in _pool_queries():
        want = jpool.query(q)
        got = tpool.query(torch.from_numpy(q))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert tpool.num_ws == jpool.num_ws
    for a, b in zip(tpool.ws, jpool.ws):
        np.testing.assert_array_equal(a.numpy(), b)


def test_e4e_coach_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E4eCoach(E4eConfig(output_size=32))
