"""The port's RB-WebFace harness against the JAX package's
(``eval/rb_webface.py``), on the CPU.

  * ``fnmr_counts`` and ``fmr_counts``: the same counts at all 20
    thresholds on seeded 8-d unit embeddings (their similarities spread
    over the thresholds' range), the impostor sweep with a chunk smaller
    than the list and a list that is no multiple of it, so the last chunk
    is ragged; the count of pairs equal;
  * ``tpr_at_fpr`` equal to the JAX function;
  * ``evaluate_model`` through the port's CLI (``--device cpu``) against
    JAX's ``evaluate_model``, on a tiny PNG partition (2 groups, 3
    identities x 5 images and 12 negatives each, 120 px images), with the
    same ``MobileFaceNet`` weights: every group's FNR and FPR curves
    equal, TPR@FPR within 1e-12.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.eval import make_embed_fn as jmake_embed_fn
from stylegan_for_facerec_tpu.eval import rb_webface as jrb
from stylegan_for_facerec_tpu.models import mobilefacenet as jmfn
from stylegan_for_facerec_tpu.utils.torch_convert import from_torch
from stylegan_for_facerec_torch.eval import rb_webface as rb
from stylegan_for_facerec_torch.models.mobilefacenet import MobileFaceNet
from stylegan_for_facerec_torch.tools import test_rb_webface
from test_torch_backbone_zoo import seeded

THRESHOLDS = np.linspace(0.3, 0.6, num=20)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n, d=8):
    e = rng.randn(n, d).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def test_fnmr_counts_match_jax():
    rng = np.random.RandomState(0)
    pos = _unit(rng, 53)                   # 10 identities and a ragged 3
    want, n_want = jrb.fnmr_counts(pos, THRESHOLDS)
    got, n_got = rb.fnmr_counts(pos, THRESHOLDS, device="cpu")
    assert n_got == n_want == 100
    np.testing.assert_array_equal(got, want)
    assert 0 < got[0] < got[-1] < n_got


@pytest.mark.parametrize("n,chunk", [(203, 64), (64, 64), (50, 2048)])
def test_fmr_counts_match_jax(n, chunk):
    neg = _unit(np.random.RandomState(n), n)
    want, n_want = jrb.fmr_counts(neg, THRESHOLDS, chunk=chunk)
    got, n_got = rb.fmr_counts(neg, THRESHOLDS, chunk=chunk, device="cpu")
    assert n_got == n_want == n * (n - 1) // 2
    np.testing.assert_array_equal(got, want)
    assert got[0] > got[-1] > 0


def test_tpr_at_fpr_matches_jax():
    all_fpr = np.array([0.5, 0.1, 1e-2, 1e-3, 1e-4, 1e-5])
    all_fnr = np.array([0.01, 0.05, 0.1, 0.2, 0.35, 0.5])
    for target in (1e-3, 1e-4, 3e-3, 0.7):
        assert rb.tpr_at_fpr(all_fpr, all_fnr, target) == \
            jrb.tpr_at_fpr(all_fpr, all_fnr, target)


GROUPS = ("African", "Indian")


@pytest.fixture(scope="module")
def partition(tmp_path_factory):
    """PNG images and partition lists: per group, 3 identities of 5
    images (a base image plus strong noise, so that the genuine
    similarities spread over the thresholds) and 12 negatives."""
    root = tmp_path_factory.mktemp("rbw")
    rng = np.random.RandomState(5)
    (root / "lists").mkdir()
    for grp in GROUPS:
        (root / "images" / grp).mkdir(parents=True)
        pos, neg = [], []
        for ident in range(3):
            base = rng.randint(0, 256, (120, 120, 3))
            for j in range(5):
                img = np.clip(base + rng.randint(-120, 121, base.shape), 0,
                              255).astype(np.uint8)
                name = f"{grp}/id{ident}_{j}.png"
                Image.fromarray(img).save(root / "images" / name)
                pos.append(name)
        for j in range(12):
            name = f"{grp}/neg{j}.png"
            Image.fromarray(rng.randint(0, 256, (120, 120, 3)).astype(
                np.uint8)).save(root / "images" / name)
            neg.append(name)
        (root / "lists" / f"pos_pairs_samples_{grp}.txt").write_text(
            "\n".join(pos))
        (root / "lists" / f"neg_pairs_samples_{grp}.txt").write_text(
            "\n".join(neg))
    # the last BatchNorm's statistics taken over these images, so that the
    # random net's embeddings spread (its shared component removed)
    model = seeded(MobileFaceNet(embedding_size=64), 6)
    names = [f"{grp}/{n}" for grp in GROUPS for n in sorted(
        os.listdir(root / "images" / grp))]
    x = np.stack([rb.load_image(str(root / "images" / n)) for n in names])
    with torch.no_grad():
        model.bn.reset_running_stats()
        model.bn.momentum = None
        model.bn.weight.fill_(1.0)
        model.bn.bias.zero_()
        model.bn.train()
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    model.eval()
    torch.save({"backbone": model.state_dict()}, root / "s3.pt")
    return root, model


def test_evaluate_model_through_the_cli_matches_jax(partition):
    root, model = partition
    got = test_rb_webface.main([
        "--checkpoint", str(root / "s3.pt"),
        "--data_path", str(root / "images"),
        "--partition_path", str(root / "lists"),
        "--backbone", "MobileFaceNet", "--emb_size", "64",
        "--batch_size", "8", "--groups", *GROUPS, "--device", "cpu"])
    jm = jmfn.MobileFaceNet(embedding_size=64)
    params, state = from_torch(jm, {k: v.numpy() for k, v in
                                    model.state_dict().items()})
    embed_fn = jmake_embed_fn(jm, params, state, tta=False, ccrop=False)
    want = jrb.evaluate_model(embed_fn, str(root / "images"),
                              str(root / "lists"), batch_size=8,
                              groups=GROUPS)
    assert sorted(got) == sorted(want) == sorted(GROUPS)
    for grp in GROUPS:
        np.testing.assert_array_equal(got[grp]["fnr_curve"],
                                      want[grp]["fnr_curve"])
        np.testing.assert_array_equal(got[grp]["fpr_curve"],
                                      want[grp]["fpr_curve"])
        for k in ("tpr_at_fpr_1e3", "tpr_at_fpr_1e4"):
            assert abs(got[grp][k] - want[grp][k]) <= 1e-12, (grp, k)
    # the curves move across the thresholds
    fnr, fpr = got[GROUPS[0]]["fnr_curve"], got[GROUPS[0]]["fpr_curve"]
    assert fnr[-1] > fnr[0] and fpr[0] > fpr[-1]


def test_embeddings_are_the_preprocessed_images_through_the_backbone(
        partition):
    """``embed_images``: PIL bilinear 128, centre crop 112, [-1, 1], then
    the backbone, L2-normalized; the tail batch padded."""
    root, model = partition
    names = [f"African/id0_{j}.png" for j in range(5)]
    from stylegan_for_facerec_torch.eval.verify_runner import make_embed_fn
    fn = make_embed_fn(model, tta=False, ccrop=False, device="cpu")
    got = rb.embed_images(fn, str(root / "images"), names, batch_size=4)
    img = Image.open(os.path.join(root / "images", names[4])).convert(
        "RGB").resize((128, 128), Image.BILINEAR)
    x = (np.asarray(img, np.float32)[8:120, 8:120] / 255.0 - 0.5) / 0.5
    # the tail batch as embed_images pads it: the image and 3 zeros
    batch = torch.zeros(4, 3, 112, 112)
    batch[0] = torch.from_numpy(x).permute(2, 0, 1)
    with torch.no_grad():
        e = model.eval()(batch)[0]
    np.testing.assert_allclose(got[4], (e / e.norm()).numpy(), rtol=1e-6,
                               atol=1e-7)
    assert got.shape == (5, 64)
    assert jnp.allclose(jnp.linalg.norm(got, axis=1), 1.0, atol=1e-5)
