"""The port's pSp encoder family against the JAX package, on the CPU, in f32:
``resize_bilinear_align_corners``, ``GradualStyleEncoder`` (the FPN),
``ResNetBackboneEncoder`` with its ``BasicBlock``s, ``PSPOutputLayer``, the
"pSp" and "both" heads of ``BackboneEncoderDiffHead`` and
``build_encoder``.

Each test builds the JAX module, gives its BatchNorm running statistics,
biases and (for the ResNet blocks, whose last BatchNorm weight is zero at
init) BatchNorm weights seeded non-trivial values, carries the weights
across with ``from_jax`` (strict) and runs both on the same numpy inputs,
at 32 px where the architecture allows it.

Tolerances, with their reasons:
  * encoders and heads: 1e-4 of the output's largest magnitude. Their
    convolutions sum in another order than XLA's through up to 50 layers
    (``test_torch_models.py`` holds the pSp encoder to 1e-4 as well);
  * the align-corners resize: 1e-5 of scale. Both sides apply the same
    f32 interpolation matrices, summing at most a few products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models import psp as jpsp
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.ops.image import (
    resize_bilinear_align_corners as jresize_ac)
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch.models import e4e, psp, resnet
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.ops.image import resize_bilinear_align_corners
from stylegan_for_facerec_torch.utils.convert import _flattened_maps, from_jax
from test_torch_models import assert_close_scaled, nchw, nhwc, perturbed

CTX = Ctx(train=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bn_weights_perturbed(layer, seed):
    """``perturbed``, and every BatchNorm weight drawn from U(0.5, 1.5)."""
    params, state = perturbed(layer, seed)
    rng = np.random.RandomState(seed + 1000)

    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v, s.get(k, {}) if isinstance(s, dict) else {})
        if "mean" in s and "weight" in p:
            p["weight"] = rng.uniform(0.5, 1.5,
                                      p["weight"].shape).astype(np.float32)

    walk(params, state)
    return params, state


def port_of(tm, params, state):
    """``tm`` with the JAX weights, checked key for key against
    ``to_torch``."""
    got = from_jax(tm, params, state)
    tm.load_state_dict(got, strict=True)
    return tm.eval()


def check_to_torch(jm, params, state, tm):
    """``from_jax`` equals ``to_torch`` told of each flattened map (the
    facerec heads' Linear reads an (H, W, C)-ordered input in JAX)."""
    info = {name: (h, w, tm.get_submodule(name).in_features // (h * w))
            for name, (h, w) in _flattened_maps(tm).items()}
    want = to_torch(jm, params, state, flatten_info=info)
    got = from_jax(tm, params, state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def run_both(jm, params, state, tm, x, ctx=CTX):
    want, new_state = jm.apply(params, state, jnp.asarray(x), ctx)
    with torch.no_grad():
        got = tm(nchw(x))
    return want, new_state, got


@pytest.mark.parametrize("hw,out", [((1, 1), (4, 3)), ((4, 5), (1, 1)),
                                    ((3, 7), (7, 3)), ((2, 2), (2, 2)),
                                    ((16, 16), (32, 32)), ((5, 4), (9, 13))])
def test_resize_bilinear_align_corners_matches_jax(hw, out):
    x = np.random.RandomState(40).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jresize_ac(jnp.asarray(x), *out))
    got = nhwc(resize_bilinear_align_corners(nchw(x), *out))
    assert got.shape == (2, *out, 3)
    assert_close_scaled(got, want, 1e-5)
    # torch's own align-corners resize computes the same function
    ref = torch.nn.functional.interpolate(nchw(x), size=out, mode="bilinear",
                                          align_corners=True)
    assert_close_scaled(got, nhwc(ref), 1e-5)


@pytest.fixture(scope="module")
def fpn_pair():
    """JAX GradualStyleEncoder (IR-SE-50, 8 styles: 3 coarse, 4 middle, 1
    fine) and the port's, with the same weights."""
    jm = jpsp.GradualStyleEncoder(50, "ir_se", n_styles=8, input_nc=6)
    params, state = perturbed(jm, 41)
    tm = port_of(psp.GradualStyleEncoder(50, "ir_se", n_styles=8,
                                         input_nc=6), params, state)
    return jm, params, state, tm


def test_gradual_style_encoder_from_jax_equals_to_torch(fpn_pair):
    check_to_torch(*fpn_pair)


def test_gradual_style_encoder_matches_jax(fpn_pair):
    """32 px input: taps at 8x8 (unit 6), 4x4 (20) and 2x2 (23)."""
    jm, params, state, tm = fpn_pair
    x = np.random.RandomState(42).randn(2, 32, 32, 6).astype(np.float32)
    want, _, got = run_both(jm, params, state, tm, x)
    assert got.shape == (2, 8, 512)
    assert_close_scaled(got.numpy(), np.asarray(want), 1e-4)


def test_gradual_style_encoder_train_mode_matches_jax(fpn_pair):
    jm, params, state, _ = fpn_pair
    tm = psp.GradualStyleEncoder(50, "ir_se", n_styles=8, input_nc=6)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    x = np.random.RandomState(43).randn(2, 32, 32, 6).astype(np.float32)
    want, new_state = jm.apply(params, state, jnp.asarray(x),
                               Ctx(train=True))
    with torch.no_grad():
        got = tm.train()(nchw(x))
    assert_close_scaled(got.numpy(), np.asarray(want), 1e-4)
    want_sd = {k: np.asarray(v) for k, v in
               to_torch(jm, params, new_state).items()}
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert_close_scaled(v.numpy(), want_sd[k], 1e-4)


@pytest.mark.parametrize("inplanes,planes,stride,down",
                         [(16, 16, 1, False), (16, 32, 2, True)])
def test_basic_block_matches_jax(inplanes, planes, stride, down):
    from stylegan_for_facerec_tpu.models import resnet as jresnet
    jm = jresnet.BasicBlock(inplanes, planes, stride, has_downsample=down)
    params, state = bn_weights_perturbed(jm, 44)
    tm = port_of(resnet.BasicBlock(inplanes, planes, stride,
                                   has_downsample=down), params, state)
    check_to_torch(jm, params, state, tm)
    x = np.random.RandomState(45).randn(2, 8, 8, inplanes).astype(np.float32)
    want, _, got = run_both(jm, params, state, tm, x)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_basic_block_init_zeroes_last_bn():
    b = init_weights(resnet.BasicBlock(8, 16, 2, has_downsample=True),
                     torch.Generator().manual_seed(0))
    assert torch.count_nonzero(b.bn2.weight) == 0
    assert torch.all(b.bn1.weight == 1)
    assert b.downsample[0].weight.abs().max() > 0


@pytest.mark.parametrize("head,size", [("pSp", 32), ("facerec", 112)])
def test_resnet_backbone_encoder_matches_jax(head, size):
    """The pSp head at 32 px (2x2 map, spatial-16 heads); the facerec head
    at 112 px (its 7x7 map)."""
    jm = jpsp.ResNetBackboneEncoder(n_styles=3, input_nc=6,
                                    output_layer_type=head)
    params, state = bn_weights_perturbed(jm, 46)
    tm = port_of(psp.ResNetBackboneEncoder(n_styles=3, input_nc=6,
                                           output_layer_type=head),
                 params, state)
    check_to_torch(jm, params, state, tm)
    x = np.random.RandomState(47).randn(2, size, size, 6).astype(np.float32)
    want, _, got = run_both(jm, params, state, tm, x)
    assert got.shape == ((2, 3, 512) if head == "pSp" else (2, 512))
    assert_close_scaled(got.numpy(), np.asarray(want), 1e-4)


def test_psp_output_layer_matches_jax():
    jm = jpsp.PSPOutputLayer(512, 512, 9, n_styles=3)
    params, state = perturbed(jm, 48)
    tm = port_of(psp.PSPOutputLayer(512, 512, 9, n_styles=3), params, state)
    check_to_torch(jm, params, state, tm)
    x = np.random.RandomState(49).randn(2, 7, 7, 512).astype(np.float32)
    want, _, got = run_both(jm, params, state, tm, x)
    assert got.shape == (2, 3, 512)
    assert_close_scaled(got.numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("head", ["pSp", "both"])
def test_diff_head_psp_heads_match_jax(head):
    """BackboneEncoderDiffHead at 32 px (end map 2x2): the pSp head alone,
    or with the facerec embedding as {"facerec", "pSp"}."""
    jm = jpsp.BackboneEncoderDiffHead(50, "ir_se", n_styles=3, input_size=32,
                                      output_layer_type=head)
    params, state = perturbed(jm, 50)
    tm = port_of(psp.BackboneEncoderDiffHead(
        50, "ir_se", input_size=32, output_layer_type=head, n_styles=3),
        params, state)
    check_to_torch(jm, params, state, tm)
    x = np.random.RandomState(51).randn(2, 32, 32, 6).astype(np.float32)
    want, _, got = run_both(jm, params, state, tm, x)
    if head == "pSp":
        want, got = {"pSp": want}, {"pSp": got}
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close_scaled(got[k].numpy(), np.asarray(want[k]), 1e-4)
    assert got["pSp"].shape == (2, 3, 512)


def test_diff_head_rejects_unknown_type():
    with pytest.raises(ValueError, match="output_layer_type"):
        psp.BackboneEncoderDiffHead(output_layer_type="styles")
    with pytest.raises(ValueError, match="output_layer_type"):
        psp.ResNetBackboneEncoder(output_layer_type="both")


def test_encoder_types_match_jax():
    assert psp.ENCODER_TYPES == jpsp.ENCODER_TYPES


BUILT = ["GradualStyleEncoder", "BackboneEncoder", "BackboneEncoder34",
         "BackboneEncoder100", "ResNetBackboneEncoder",
         "ProgressiveBackboneEncoder"]


@pytest.mark.parametrize("name", BUILT)
def test_build_encoder_matches_jax(name):
    """Every name the JAX ``build_encoder`` accepts: the same module, the
    same weights after ``from_jax``, the same codes at 32 px."""
    n_styles = 8 if name == "GradualStyleEncoder" else 3
    jm = jpsp.build_encoder(name, n_styles, input_nc=6)
    params, state = bn_weights_perturbed(jm, 52)
    tm = psp.build_encoder(name, n_styles, input_nc=6, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    if name == "ProgressiveBackboneEncoder":
        assert isinstance(tm, e4e.ProgressiveBackboneEncoder)
    port_of(tm, params, state)
    check_to_torch(jm, params, state, tm)
    x = np.random.RandomState(53).randn(1, 32, 32, 6).astype(np.float32)
    want, _, got = run_both(jm, params, state, tm, x)
    assert got.shape == (1, n_styles, 512)
    assert_close_scaled(got.numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("name", ["ResNetGradualStyleEncoder",
                                  "ResNetProgressiveBackboneEncoder",
                                  "NoSuchEncoder"])
def test_build_encoder_rejects_what_jax_rejects(name):
    with pytest.raises(ValueError, match="not a valid encoder"):
        jpsp.build_encoder(name, 3)
    with pytest.raises(ValueError, match="not a valid encoder"):
        psp.build_encoder(name, 3, device="cpu")


def test_build_encoder_draws_from_its_seed():
    """The same seed gives the same weights, another seed others."""
    a, b, c = (psp.build_encoder("ResNetBackboneEncoder", 2, seed=s,
                                 device="cpu") for s in (3, 3, 4))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.conv1.weight, c.conv1.weight)


def test_build_encoder_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psp.build_encoder("BackboneEncoder", 3)
