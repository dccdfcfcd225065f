"""The port's int8 serving (``utils/quantize.py``) against the JAX
package's, on the CPU.

* Op exactness: on the same int8 codes, the port's int8 conv (stride 1
  and 2, padding, 3- and 6-channel stems, depthwise, grouped, K not a
  multiple of 8), linear and modconv give JAX's int32 accumulators and
  its rescaled f32 outputs bit for bit (the demodulated modconv within
  f32 round-off: its ``styles^2 @ w_sq`` sums in another order).
* Tables: a JAX table carried across by ``Int8Table.from_jax`` has the
  port's own calibration's ``kinds`` and int8 weights exactly, and its
  ``x_absmax`` within f32 round-off (the activations are computed in
  another order).
* Whole models at the sizes of ``tests/test_quantize.py``: the port's
  int8 output against JAX's within 2e-3 of the output's range for the
  tiny net; at a cosine above 0.995 for the unit embeddings of
  ``MobileFaceNet(128)`` through ``make_embed_fn``; for ``PSp(16, 16)``
  inversion over 2 iterations with JAX's table carried across (a port
  calibration's scales differ from JAX's in the last bit, which shifts
  codes at many midpoints), the latents within 2e-3 of their range and
  the images closer to JAX's int8 images than the port's f32 images are.
  An activation within f32 round-off of a rounding midpoint takes the
  other int8 code in one package (the f32 layers between the int8 ones,
  BatchNorm for one, round differently), and that one level moves an
  output by up to a code's share of its range; through MobileFaceNet's
  ~50 int8 layers such flips add up to about half of int8's own error.
* Errors: call-order divergence and a table that is too short raise as
  in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from stylegan_for_facerec_tpu import nn as jnn
from stylegan_for_facerec_tpu.utils import quantize as jq
from stylegan_for_facerec_tpu.utils.torch_convert import from_torch
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.nn.layers import BatchNorm2d, Flatten
from stylegan_for_facerec_torch.utils import quantize as q
from stylegan_for_facerec_torch.utils.convert import load_from_jax

MODEL_REL = 2e-3
EMBED_COS = 0.995
LATENT_REL = 2e-3
DEMOD_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (in, out, k, stride, padding, groups, size)
CONVS = [(3, 16, 3, 1, 1, 1, 9),      # the embedder's stem, K = 27
         (6, 8, 3, 2, 1, 1, 10),      # the inversion encoder's stem, K = 54
         (5, 7, 3, 2, 0, 1, 9),       # K = 45, N = 7
         (8, 8, 3, 1, 1, 8, 6),       # depthwise
         (8, 16, 1, 1, 0, 2, 5),      # grouped
         (12, 6, 3, 1, 1, 3, 5)]      # grouped, K = 36 a group


@pytest.mark.parametrize("cin,cout,k,stride,pad,groups,size", CONVS)
def test_int8_conv_is_exact(cin, cout, k, stride, pad, groups, size):
    rng = np.random.RandomState(cin * 100 + cout)
    x = rng.randn(3, size, size, cin).astype(np.float32)
    w = rng.randn(k, k, cin // groups, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    jlayer = jnn.Conv2d(cin, cout, k, stride=stride, padding=pad,
                        groups=groups)
    wq, w_scale = jq._quantize_weight(jnp.asarray(w), 3)
    entry = {"w": wq, "w_scale": w_scale,
             "x_absmax": jnp.asarray(np.abs(x).max() * 0.8, jnp.float32)}
    # the accumulators on the same int8 codes
    xq, _ = jq._quantize_act(jnp.asarray(x), entry["x_absmax"])
    want_acc = lax.conv_general_dilated(
        xq, wq, (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    table = q.Int8Table.from_jax([entry], ["conv2d"])
    got_xq, _ = q.quantize_act(nchw(x), table.entries[0]["x_absmax"])
    np.testing.assert_array_equal(nhwc(got_xq), np.asarray(xq))
    acc = q.int8_conv2d(got_xq, table.entries[0]["w"], stride, pad, groups)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    # the rescaled output, bias included
    want = jq.Int8Apply([entry]).conv2d(
        jlayer, {"weight": jnp.zeros(()), "bias": jnp.asarray(b)},
        jnp.asarray(x))
    tlayer = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=pad,
                             groups=groups)
    with torch.no_grad():
        tlayer.bias.copy_(torch.from_numpy(b))
        got = q.Int8Apply(table.entries).conv2d(tlayer, nchw(x))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("fin,fout,flat", [(45, 7, None), (64, 24, None),
                                           (2 * 2 * 6, 5, (2, 2))])
def test_int8_linear_is_exact(fin, fout, flat):
    rng = np.random.RandomState(fin)
    x = rng.randn(5, fin).astype(np.float32)
    w = rng.randn(fin, fout).astype(np.float32)
    b = rng.randn(fout).astype(np.float32)
    wq, w_scale = jq._quantize_weight(jnp.asarray(w), 1)
    entry = {"w": wq, "w_scale": w_scale,
             "x_absmax": jnp.asarray(np.abs(x).max(), jnp.float32)}
    want = jq.Int8Apply([entry]).linear(
        jnn.Linear(fin, fout), {"weight": jnp.zeros(()),
                                "bias": jnp.asarray(b)}, jnp.asarray(x))
    table = q.Int8Table.from_jax([entry], ["linear"],
                                 flatten_hw=None if flat is None
                                 else {0: flat})
    tlayer = torch.nn.Linear(fin, fout)
    tx = torch.from_numpy(x)
    if flat is not None:
        # the JAX input is an NHWC map flattened (H, W, C); the port's the
        # same map NCHW flattened (C, H, W)
        h, wd = flat
        tx = nchw(x.reshape(5, h, wd, -1)).flatten(1)
    with torch.no_grad():
        tlayer.bias.copy_(torch.from_numpy(b))
        got = q.Int8Apply(table.entries).linear(tlayer, tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,demod", [(3, True), (3, False), (1, False)])
def test_int8_modconv_matches_jax(k, demod):
    rng = np.random.RandomState(k + 10 * demod)
    cin, cout = 12, 10
    x = rng.randn(2, 6, 6, cin).astype(np.float32)
    styles = (1.0 + 0.3 * rng.randn(2, cin)).astype(np.float32)
    w = rng.randn(k, k, cin, cout).astype(np.float32)
    wq, w_scale = jq._quantize_weight(jnp.asarray(w), 3)
    x_mod = x * styles[:, None, None, :]
    entry = {"w": wq, "w_scale": w_scale,
             "x_absmax": jnp.asarray(np.abs(x_mod).max(), jnp.float32)}
    if demod:
        entry["w_sq"] = jnp.sum(jnp.square(jnp.asarray(w)), axis=(0, 1))
    want = np.asarray(jq.Int8Apply([entry]).modconv(
        {}, jnp.asarray(x), jnp.asarray(styles), padding=k // 2,
        demodulate=demod))
    table = q.Int8Table.from_jax([entry], ["modconv"])
    got = nhwc(q.Int8Apply(table.entries).modconv(
        None, nchw(x), torch.from_numpy(styles), padding=k // 2,
        demodulate=demod))
    if demod:
        np.testing.assert_allclose(got, want, rtol=DEMOD_REL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _tiny():
    j = jnn.Sequential(
        jnn.Conv2d(3, 16, 3, padding=1, use_bias=False),
        jnn.BatchNorm2d(16), jnn.PReLU(16),
        jnn.Conv2d(16, 32, 3, stride=2, padding=1), jnn.PReLU(32),
        jnn.Flatten(), jnn.Linear(32 * 8 * 8, 24))
    t = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1, bias=False), BatchNorm2d(16),
        torch.nn.PReLU(16), torch.nn.Conv2d(16, 32, 3, stride=2, padding=1),
        torch.nn.PReLU(32), Flatten((8, 8)), torch.nn.Linear(32 * 8 * 8, 24))
    params, state = j.init(jax.random.key(0))
    load_from_jax(t, params, state)
    return j, params, state, t.eval()


def jax_trees(tm, jm):
    """The JAX trees of a seeded port model, by the JAX package's own
    converter (faster than JAX's eager init at these depths)."""
    return from_torch(jm, {k: v.numpy() for k, v in tm.state_dict().items()})


def _tables_agree(jtable, jkinds, ttable, flatten_hw=None):
    carried = q.Int8Table.from_jax(jtable.entries, jkinds, flatten_hw)
    assert carried.kinds == ttable.kinds
    for i, (a, b) in enumerate(zip(carried.entries, ttable.entries)):
        assert set(a) == set(b), i
        np.testing.assert_array_equal(a["w"].numpy(), b["w"].numpy())
        np.testing.assert_allclose(a["w_scale"].numpy(),
                                   b["w_scale"].numpy(), rtol=1e-7)
        np.testing.assert_allclose(a["x_absmax"].numpy(),
                                   b["x_absmax"].numpy(), rtol=1e-5)
        if "w_sq" in a:
            np.testing.assert_allclose(a["w_sq"].numpy(), b["w_sq"].numpy(),
                                       rtol=1e-5)


def _jax_calibrate(model, params, state, batches, **kw):
    rec = jq._Recorder()
    for x in batches:
        rec.begin_batch()
        model.apply(params, state, x, jnn.Ctx(train=False, quant=rec), **kw)
    return jq.Int8Table(rec.entries, rec.weight_ids), rec.kinds


def test_tiny_net_table_and_output_match_jax():
    j, params, state, t = _tiny()
    rng = np.random.RandomState(0)
    batches = [rng.randn(8, 16, 16, 3).astype(np.float32) for _ in range(3)]
    jtable, jkinds = _jax_calibrate(j, params, state,
                                    [jnp.asarray(b) for b in batches])
    table = q.calibrate_and_quantize(t, [nchw(b) for b in batches])
    assert table.kinds == jkinds == ["conv2d", "conv2d", "linear"]
    _tables_agree(jtable, jkinds, table, flatten_hw={2: (8, 8)})
    lean = q.strip_quantized_weights(t, table)
    assert lean[3].weight.shape == () and lean[3].bias.shape == (32,)
    assert lean[6].weight.dtype == torch.int8
    assert t[3].weight.shape == (32, 16, 3, 3)     # the original is kept

    x = rng.randn(8, 16, 16, 3).astype(np.float32)
    want = np.asarray(jq.quantized_apply(j, params, state, jnp.asarray(x),
                                         jtable.entries)[0])
    got = q.quantized_apply(lean, nchw(x), table).numpy()
    assert rel(got, want) < MODEL_REL


def test_mobilefacenet_embed_int8_matches_jax():
    from stylegan_for_facerec_tpu.eval import verify_runner as jvr
    from stylegan_for_facerec_tpu.models import mobilefacenet as jmfn
    from stylegan_for_facerec_torch.eval.verify_runner import make_embed_fn
    from stylegan_for_facerec_torch.models.mobilefacenet import MobileFaceNet

    jm = jmfn.MobileFaceNet(embedding_size=128)
    tm = MobileFaceNet(embedding_size=128)
    init_weights(tm, torch.Generator().manual_seed(3))
    params, state = jax_trees(tm.eval(), jm)
    rng = np.random.RandomState(3)
    calib = rng.randn(4, 112, 112, 3).astype(np.float32) * 0.5
    jtable, jkinds = _jax_calibrate(jm, params, state, [jnp.asarray(calib)])
    table = q.calibrate_and_quantize(tm, [nchw(calib)])
    _tables_agree(jtable, jkinds, table)
    assert {"conv2d", "linear"} == set(table.kinds)

    imgs = rng.randn(6, 128, 128, 3).astype(np.float32) * 0.5
    lean = jq.strip_quantized_weights(params, jtable)
    want = np.asarray(jvr.make_embed_fn(jm, lean, state,
                                        int8_table=jtable)(
        jnp.asarray(imgs)))
    tlean = q.strip_quantized_weights(tm, table)
    got = make_embed_fn(tlean, device="cpu", int8_table=table)(
        torch.from_numpy(imgs)).numpy()
    # unit embeddings: one code flip in an early layer reaches every later
    # one (measured: cos 0.9982-1.0 to JAX's int8, 0.9967-0.9978 between
    # JAX's int8 and f32)
    assert (got * want).sum(-1).min() > EMBED_COS
    f32 = make_embed_fn(tm, device="cpu")(torch.from_numpy(imgs)).numpy()
    assert (f32 * got).sum(-1).min() > 0.97


def test_inversion_int8_matches_jax():
    from stylegan_for_facerec_tpu.eval.inference import \
        run_on_batch as jrun
    from stylegan_for_facerec_tpu.models.psp import PSp as JPSp
    from stylegan_for_facerec_torch.eval.inference import run_on_batch
    from stylegan_for_facerec_torch.models.psp import build_psp

    jm = JPSp(output_size=16, input_size=16)
    tm = build_psp(16, 16, seed=7, device="cpu")
    pp, ps = jax_trees(tm, jm)
    ps["latent_avg"] = jnp.asarray(tm.latent_avg.numpy())
    avg = np.zeros((16, 16, 3), np.float32)
    rng = np.random.RandomState(7)
    calib = rng.randn(2, 16, 16, 3).clip(-1, 1).astype(np.float32)
    rec = jq._Recorder()
    rec.begin_batch()
    jrun(jm, pp, ps, jnp.asarray(calib), jnp.asarray(avg), 2, quant=rec)
    table = q.calibrate_with(
        lambda x, hook: run_on_batch(tm, x, torch.from_numpy(avg), 2,
                                     quant=hook),
        [torch.from_numpy(calib)])
    # encoder conv2d/linear and decoder modconv calls, one entry a call of
    # each of the 2 iterations, in JAX's order
    assert table.kinds == rec.kinds and len(table.kinds) > 20
    _tables_agree(jq.Int8Table(rec.entries, rec.weight_ids), rec.kinds,
                  table)

    x = rng.randn(3, 16, 16, 3).clip(-1, 1).astype(np.float32)
    lean = jq.strip_quantized_weights(pp, jq.Int8Table(rec.entries,
                                                       rec.weight_ids))
    want_o, want_l = jax.jit(lambda p, s, e, xx: jrun(
        jm, p, s, xx, jnp.asarray(avg), 2, quant=jq.Int8Apply(e)))(
        lean, ps, rec.entries, jnp.asarray(x))
    # JAX's table carried across: the same scales, so only code flips
    # separate the two int8 loops. Measured: images 4.4e-2 and 4.7e-2 of
    # the range apart (iterations 1, 2), latents 1.9e-4 and 8.8e-4, while
    # int8 itself moves the images 6.6e-2 to 7.6e-2 and the latents
    # 5.6e-4 to 1.4e-3 from f32
    carried = q.Int8Table.from_jax(rec.entries, rec.kinds)
    tlean = q.strip_quantized_weights(tm, table)
    got_o, got_l = run_on_batch(tlean, torch.from_numpy(x),
                                torch.from_numpy(avg), 2,
                                quant=q.Int8Apply(carried.entries))
    f32_o, _ = run_on_batch(tm, torch.from_numpy(x), torch.from_numpy(avg),
                            2)
    assert np.isfinite(got_o.numpy()).all()
    for it in range(2):
        assert rel(got_o[it].numpy(), want_o[it]) < rel(
            f32_o[it].numpy(), want_o[it])
    assert rel(got_l.numpy(), want_l) < LATENT_REL


def test_call_order_divergence_raises():
    conv, lin = torch.nn.Conv2d(2, 2, 1), torch.nn.Linear(2, 2)

    def forward(x, hook):
        with q.hooked(hook):
            if x.dim() == 4:
                conv(x)
            else:
                lin(x)

    with pytest.raises(ValueError, match="call order diverged"):
        q.calibrate_with(forward, [torch.ones(1, 2, 3, 3), torch.ones(1, 2)])


def test_short_table_raises():
    _, _, _, t = _tiny()
    table = q.calibrate_and_quantize(t, [torch.randn(2, 3, 16, 16)])
    short = q.Int8Table(table.entries[:2], table.kinds[:2])
    with pytest.raises(ValueError, match="quantized table has 2 entries"):
        q.quantized_apply(t, torch.randn(2, 3, 16, 16), short)
    # the hook is removed again after the error
    assert q.active_hook() is None
    assert torch.nn.Conv2d.forward is q._CONV_FORWARD
