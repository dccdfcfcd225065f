"""The port's evaluation tools against the JAX package on the CPU:
``make_embed_fn(quantize=False)``, ``extract_features_from_folder`` and
``extract_feature_single`` on a folder of seeded PNGs (a 4-unit IR-SE
``Backbone`` at 112 carried with ``from_jax``), ``GTResDataset``, the
demographic labels of ``ImagesDataset``, the ``calc_losses_on_images``
CLI (l2, lpips, id) against the JAX CLI's numbers, ``radam_torch``
against optax over 10 steps, and ``profile_trace``.

Tolerances: embeddings 1e-4 (unit vectors; ~20 convolutions summed in
other orders); dataset items exactly; the CLI's means and standard
deviations 1e-5 relative for l2 and 1e-4 for LPIPS and ID; RAdam's
parameters within 4 f32 ulps of their magnitude plus 1e-7 (the step
constants are computed in f32 as optax does)."""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.data import images_dataset as jimages
from stylegan_for_facerec_tpu.eval import inference as jinf
from stylegan_for_facerec_tpu.eval import verify_runner as jrun
from stylegan_for_facerec_tpu.losses.perceptual import LPIPS as JLPIPS
from stylegan_for_facerec_tpu.models import irse as jirse
from stylegan_for_facerec_tpu.train import optim as joptim
from stylegan_for_facerec_torch.data import GTResDataset, ImagesDataset
from stylegan_for_facerec_torch.eval import (extract_feature_single,
                                             extract_features_from_folder)
from stylegan_for_facerec_torch.eval.verify_runner import make_embed_fn
from stylegan_for_facerec_torch.losses.perceptual import LPIPS
from stylegan_for_facerec_torch.models import irse
from stylegan_for_facerec_torch.tools import calc_losses_on_images
from stylegan_for_facerec_torch.train.optim import radam_constants, radam_torch
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax
from stylegan_for_facerec_torch.utils.logging import profile_trace
from test_torch_facerec_models import JTinyBackbone, perturbed, tiny_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jm = JTinyBackbone(input_size=112, num_layers=50, mode="ir_se",
                       emb_size=32)
    params, state = perturbed(jm, 3)
    tm = irse.Backbone(112, 50, "ir_se", emb_size=32)
    tiny_port(tm, tm)
    load_from_jax(tm, params, state)
    return jm, params, state, tm.eval()


def _png(path, seed, size):
    rng = np.random.RandomState(seed)
    # a smooth field plus noise, so resizing and cropping matter
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([np.sin(6 * xx + seed), np.cos(5 * yy), xx * yy], -1)
    img = 127.5 + 90 * base + 20 * rng.randn(size, size, 3)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    """Two identities of 3 and 2 images at 100 and 120 px."""
    root = tmp_path_factory.mktemp("faces")
    for ident, n in (("Asian^id0", 3), ("id1", 2)):
        (root / ident).mkdir()
        for i in range(n):
            _png(root / ident / f"{i}.png", 10 * len(ident) + i,
                 100 if i % 2 else 120)
    return root


def test_make_embed_fn_without_quantization_matches_jax(tiny):
    jm, params, state, tm = tiny
    x = np.random.RandomState(4).uniform(-1, 1, (3, 100, 100, 3)).astype(
        np.float32)
    want = np.asarray(jrun.make_embed_fn(jm, params, state,
                                         quantize=False)(jnp.asarray(x)))
    fn = make_embed_fn(tm, device="cpu", quantize=False)
    got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    quantized = make_embed_fn(tm, device="cpu")(torch.from_numpy(x))
    assert not torch.equal(quantized, torch.from_numpy(got))


def test_extract_features_from_folder_matches_jax(tiny, faces):
    jm, params, state, tm = tiny
    want = jinf.extract_features_from_folder(jm, params, state, str(faces),
                                             emb_size=32, batch_size=4)
    got = extract_features_from_folder(tm, str(faces), emb_size=32,
                                       batch_size=4, device="cpu")
    assert got.shape == (5, 32)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("tta", [True, False])
def test_extract_feature_single_matches_jax(tiny, faces, tta):
    jm, params, state, tm = tiny
    path = str(faces / "id1" / "0.png")
    want = jinf.extract_feature_single(jm, params, state, path, tta=tta)
    got = extract_feature_single(tm, path, tta=tta, device="cpu")
    assert got.shape == (1, 32) and not tm.training
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def result_gt(tmp_path_factory):
    """5 result images with ground truth of the same name, 1 without;
    ground truth at another size, so the resize counts."""
    root = tmp_path_factory.mktemp("losses")
    res, gt = root / "res", root / "gt"
    res.mkdir()
    gt.mkdir()
    for i in range(6):
        _png(res / f"f{i}.png", 100 + i, 96)
        if i != 2:
            _png(gt / f"f{i}.png", 200 + i, 128)
    return res, gt


@pytest.mark.parametrize("size", [None, 64])
def test_gt_res_dataset_equals_jax(result_gt, size):
    res, gt = result_gt
    want = jimages.GTResDataset(str(res), str(gt), size=size)
    got = GTResDataset(str(res), str(gt), size=size)
    assert got.pairs == want.pairs and len(got) == 5
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)


def test_demographic_labels_equal_jax(result_gt, tmp_path):
    res, gt = result_gt
    labels = tmp_path / "demog.txt"
    labels.write_text("f0.png 3\nf1.png 1\nf4.png 2\n")
    want = jimages.ImagesDataset(str(gt), str(gt),
                                 demog_labels_file=str(labels))
    got = ImagesDataset(str(gt), str(gt), demog_labels_file=str(labels))
    assert [got[i][2] for i in range(len(got))] == [3, 1, 0, 2, 0] == \
        [want[i][2] for i in range(len(want))]
    for a, b in zip(got[1][:2], want[1][:2]):
        np.testing.assert_array_equal(a, b)
    assert len(ImagesDataset(str(gt))[0]) == 2


def _run_jax_cli(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_calc_losses", os.path.join(REPO, "tools",
                                        "calc_losses_on_images.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["calc_losses_on_images.py"] + argv
    try:
        mod.main()
    finally:
        sys.argv = old


def test_calc_losses_cli_matches_jax(result_gt, tmp_path, capsys):
    """The JAX CLI with its seeded LPIPS (key 0) and ID backbone (key 1);
    the port's CLI with those weights carried over as state_dict files,
    and without them (seeded weights, the same warnings)."""
    res, gt = result_gt
    args = ["--data_path", str(res), "--gt_path", str(gt), "--mode", "l2",
            "lpips", "id", "--batch_size", "4"]
    _run_jax_cli(args)
    with open(res / "stat_losses.json") as f:
        want = json.load(f)
    jout = capsys.readouterr().out
    lp_params, lp_state = JLPIPS().init(jax.random.key(0))
    id_params, id_state = jirse.Backbone(
        input_size=112, num_layers=50, mode="ir_se",
        drop_ratio=0.6).init(jax.random.key(1))
    torch.save(from_jax(LPIPS("alex"), lp_params, lp_state),
               tmp_path / "lpips.pt")
    torch.save({"state_dict": from_jax(
        irse.Backbone(112, 50, "ir_se", drop_ratio=0.6), id_params,
        id_state)}, tmp_path / "id.pt")
    got = calc_losses_on_images.main(args + [
        "--lpips_weights", str(tmp_path / "lpips.pt"), "--id_checkpoint",
        str(tmp_path / "id.pt"), "--device", "cpu"])
    with open(res / "stat_losses.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want) == {"l2", "lpips", "id"}
    for mode, rel in (("l2", 1e-5), ("lpips", 1e-4), ("id", 1e-4)):
        for stat in ("mean", "std"):
            assert got[mode][stat] == pytest.approx(
                want[mode][stat], rel=rel, abs=1e-7), (mode, stat)
    assert got["lpips"]["mean"] > 0 and got["id"]["std"] > 0
    capsys.readouterr()
    seeded = calc_losses_on_images.main(
        ["--data_path", str(res), "--gt_path", str(gt), "--mode", "lpips",
         "id", "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("[warn] random-init LPIPS (no --lpips_weights)",
                 "[warn] random-init ID backbone (no --id_checkpoint)",
                 "5 pairs"):
        assert line in out and line in jout
    assert np.isfinite([v["mean"] for v in seeded.values()]).all()


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_radam_torch_matches_optax(weight_decay):
    """10 steps on a conv weight and a bias: steps 1-5 take the
    unrectified branch (rho_t < 5), 6-10 the rectified one."""
    assert [radam_constants(t, 0.95, 0.999)[2] is None
            for t in range(1, 11)] == [True] * 5 + [False] * 5
    rs = np.random.RandomState(5)
    p0 = {"w": rs.randn(4, 3, 3, 3).astype(np.float32),
          "b": rs.randn(4).astype(np.float32)}
    tx = joptim.radam_torch(1e-2, weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = radam_torch(list(tp.values()), 1e-2, weight_decay=weight_decay)
    for _ in range(10):
        g = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, u)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        opt.step()
        for k, v in tp.items():
            want = np.asarray(jp[k])
            np.testing.assert_allclose(
                v.detach().numpy(), want, rtol=0,
                atol=4 * np.finfo(np.float32).eps * np.abs(want).max()
                + 1e-7, err_msg=k)
    moved = np.abs(tp["w"].detach().numpy() - p0["w"]).max()
    assert moved > 1e-2


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir), device="cpu") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    name, spans = sorted(os.listdir(log_dir), reverse=True)
    assert name.startswith("trace_") and spans == "spans" + name[5:]
    with open(log_dir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def test_entry_points_default_to_the_gpu(result_gt, faces, tiny):
    """The loss CLI and the feature extractors take the card unless told
    otherwise, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    res, gt = result_gt
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calc_losses_on_images.main(["--data_path", str(res), "--gt_path",
                                    str(gt), "--mode", "l2"])
    tm = tiny[3]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features_from_folder(tm, str(faces))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_feature_single(tm, str(faces / "id1" / "0.png"))
