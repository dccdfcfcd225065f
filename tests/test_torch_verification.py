"""The port's verification path against the JAX package's, on the CPU.

  * ``eval.verification`` is a numpy copy: its results equal the JAX
    module's exactly on seeded embeddings and pairs.
  * ``perform_val`` with centre-crop TTA, on a 4-unit ``PSpFaceRec``
    (``test_torch_facerec_models.py``'s) carried with ``from_jax``, against
    the JAX ``perform_val``: the same accuracy and threshold, embeddings
    within 1e-4.
  * The image primitives (``quantize_uint8_roundtrip``, ``hflip``,
    ``center_crop``, ``crop_at``/``flip_at`` at the offsets JAX drew)
    equal JAX's; ``ccrop_tta`` equals it without the quantization and to
    within one uint8 step with it (the resize's sums differ by an ulp, and
    a value on a step boundary floors to either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.eval import verification as jver
from stylegan_for_facerec_tpu.eval import verify_runner as jrun
from stylegan_for_facerec_tpu.ops import image as jimage
from stylegan_for_facerec_torch.eval import verification, verify_runner
from stylegan_for_facerec_torch.ops import image
from stylegan_for_facerec_torch.utils.convert import load_from_jax
from test_torch_facerec_models import JTinyPSpFaceRec, perturbed, tiny_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _embeddings(seed, n_pairs=60, d=16):
    rng = np.random.RandomState(seed)
    e = rng.randn(2 * n_pairs, d).astype(np.float32)
    issame = rng.rand(n_pairs) < 0.5
    # same pairs closer than different ones, with overlap
    e[1::2][issame] = e[0::2][issame] + 0.7 * rng.randn(
        int(issame.sum()), d).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True), issame


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("n,folds", [(60, 10), (63, 10), (7, 3)])
def test_kfold_indices_equal(n, folds):
    for (tr, te), (jtr, jte) in zip(verification.kfold_indices(n, folds),
                                    jver.kfold_indices(n, folds)):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_equals_jax(seed):
    e, issame = _embeddings(seed)
    _equal(verification.evaluate(e, issame), jver.evaluate(e, issame))
    _equal(verification.evaluate(e, issame, 5),
           jver.evaluate(e, issame, 5))


def test_roc_accuracy_and_val_equal_jax():
    e, issame = _embeddings(2)
    thr = np.arange(0, 4, 0.05)
    e1, e2 = e[0::2], e[1::2]
    _equal(verification.calculate_roc(thr, e1, e2, issame, 4),
           jver.calculate_roc(thr, e1, e2, issame, 4))
    assert verification.calculate_val(thr, e1, e2, issame, 1e-1, 4) == \
        jver.calculate_val(thr, e1, e2, issame, 1e-1, 4)
    dist = np.sum(np.square(e1 - e2), axis=1)
    for t in (0.3, 1.0, 1.7):
        assert verification.calculate_accuracy(t, dist, issame) == \
            jver.calculate_accuracy(t, dist, issame)
        assert verification._val_far(t, dist, issame) == \
            jver._val_far(t, dist, issame)


def _images(seed, n, size):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (n, size, size, 3))
    return (u8 / 127.5 - 1.0).astype(np.float32)


def test_quantize_flip_and_center_crop_equal_jax():
    rng = np.random.RandomState(3)
    x = rng.uniform(-1.2, 1.2, (2, 20, 18, 3)).astype(np.float32)
    for fn, args in (("quantize_uint8_roundtrip", ()), ("hflip", ()),
                     ("center_crop", (11,)), ("normalize_pm1", ())):
        got = getattr(image, fn)(torch.from_numpy(x), *args).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jimage, fn)(jnp.asarray(x), *args)),
            err_msg=fn)


def test_crop_at_and_flip_at_equal_jax_on_its_draws():
    x = _images(4, 5, 36)
    key = jax.random.key(5)
    want = jimage.random_crop(key, jnp.asarray(x), 28)
    kh, kw = jax.random.split(key)
    tops = np.array(jax.random.randint(kh, (5,), 0, 9))
    lefts = np.array(jax.random.randint(kw, (5,), 0, 9))
    got = image.crop_at(torch.from_numpy(x), torch.from_numpy(tops),
                        torch.from_numpy(lefts), 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flips = np.array(jax.random.bernoulli(key, 0.5, (5,)))
    want = jimage.random_hflip(key, jnp.asarray(x))
    got = image.flip_at(torch.from_numpy(x), torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < flips.sum() < 5
    # the port's own draws: offsets in range, the same for the same seed
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    a = image.random_crop(torch.from_numpy(x), 28, g1)
    b = image.random_crop(torch.from_numpy(x), 28, g2)
    assert a.shape == (5, 28, 28, 3) and torch.equal(a, b)
    t, l = image.draw_crop_offsets(1000, 36, 36, 28, g1)
    assert int(t.min()) == 0 and int(t.max()) == 8 and int(l.max()) == 8


def test_ccrop_tta_matches_jax():
    x = _images(6, 3, 112)
    got = image.ccrop_tta(torch.from_numpy(x), quantize=False).numpy()
    want = np.asarray(jimage.ccrop_tta(jnp.asarray(x), quantize=False))
    assert got.shape == (3, 112, 112, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = image.ccrop_tta(torch.from_numpy(x)).numpy()
    want = np.asarray(jimage.ccrop_tta(jnp.asarray(x)))
    diff = np.abs(got - want)
    assert diff.max() <= 2 / 255 + 1e-6
    assert (diff > 0).mean() < 1e-3


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JTinyPSpFaceRec(size=112, emb_size=32)
    params, state = perturbed(jm, 7)
    state["avg_image"] = np.random.RandomState(8).uniform(
        -1, 1, (112, 112, 3)).astype(np.float32)
    from stylegan_for_facerec_torch.models import psp
    tm = psp.PSpFaceRec(size=112, emb_size=32)
    tiny_port(tm, tm.encoder)
    load_from_jax(tm, params, state)
    return jm, params, state, tm


def test_perform_val_matches_jax(tiny_pair):
    """20 pairs of 100 px images (resized to 128 and centre-cropped by
    the TTA); every third pair an image and its copy under strong noise,
    so the accuracy is neither 0.5 nor 1; batch 16 leaves a ragged tail."""
    jm, params, state, tm = tiny_pair
    x = _images(9, 40, 100)
    issame = np.zeros(20, bool)
    issame[::3] = True
    x[1::2][issame] = np.clip(x[0::2][issame] + 0.8
                              * np.random.RandomState(10).randn(
                                  7, 100, 100, 3), -1, 1)
    acc, thr, (tpr, fpr) = verify_runner.perform_val(
        tm, x, issame, batch_size=16, emb_size=32, nrof_folds=5,
        device="cpu")
    jacc, jthr, (jtpr, jfpr) = jrun.perform_val(
        jm, params, state, jnp.asarray(x), issame, batch_size=16,
        emb_size=32, nrof_folds=5)
    assert acc == jacc and thr == jthr
    np.testing.assert_array_equal(tpr, jtpr)
    assert 0.5 < acc < 1.0
    emb = verify_runner.compute_embeddings(
        verify_runner.make_embed_fn(tm, device="cpu"), x, 16, 32)
    jemb = jrun.compute_embeddings(jrun.make_embed_fn(jm, params, state),
                                   x, 16, 32)
    np.testing.assert_allclose(emb, jemb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)


def test_embed_fn_leaves_mode_and_reads_nchw(tiny_pair):
    _, _, _, tm = tiny_pair
    tm.train()
    fn = verify_runner.make_embed_fn(tm, tta=False, ccrop=False,
                                     device="cpu")
    x = _images(11, 4, 112)
    a = fn(torch.from_numpy(x))
    assert tm.training
    b = verify_runner.compute_embeddings(fn, np.moveaxis(x, -1, 1), 3, 32)
    np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    tm.eval()


def test_load_val_pair_and_rfw(tmp_path):
    x = _images(12, 4, 112)
    issame = np.array([True, False])
    for eth in verify_runner.RFW_ETHNICITIES:
        np.savez(tmp_path / f"rfw_{eth}.npz", images=x, issame=issame)
    data = verify_runner.get_rfw_val_data(str(tmp_path))
    assert sorted(data) == sorted(verify_runner.RFW_ETHNICITIES)
    np.testing.assert_array_equal(data["Asian"][0], x)
    jx, jsame = jrun.load_val_pair(str(tmp_path / "rfw_Indian"))
    np.testing.assert_array_equal(data["Indian"][1], jsame)
    with pytest.raises(FileNotFoundError):
        verify_runner.load_val_pair(str(tmp_path / "nope"))


def test_embed_defaults_to_the_gpu(tiny_pair):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_runner.make_embed_fn(tiny_pair[3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_runner.perform_val(tiny_pair[3], _images(13, 2, 112),
                                  np.array([True]))
