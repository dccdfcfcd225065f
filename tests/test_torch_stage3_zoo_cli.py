"""The port's stage-3 CLI pieces on the CPU: the backbones
``train_stage3.build_backbone`` builds, ``Stage3Config.remat``, the two
stage-2 handoffs (a JAX package run directory, read without JAX, and a
reference torch ``.pt``), a CLI run with a zoo backbone and
``test_rfw --roc_dir``.

  * ``build_backbone`` accepts the names the JAX CLI builds and refuses
    the same unknown ones (SystemExit), checked against the JAX CLI's own
    ``build_backbone``;
  * remat: two steps of a trainer with ``remat`` against the same trainer
    without it (a 4-unit ``PSpFaceRec`` at 32 px with block dropout 0.15,
    the recipe's, and output dropout 0.5): the same loss, the same
    updates and BatchNorm statistics (f32 round-off only: the checkpointed
    forward recomputes the same operations; 1e-6 of scale), the same
    dropout draws, and the statistics moved once a step;
  * the JAX run directory: a checkpoint written by the JAX package's
    ``save_checkpoint`` (a ``PSpFaceRec``'s params and state and an SGD
    state) read by ``utils.checkpoint.read_jax_checkpoint`` equal leaf for
    leaf to the JAX package's ``load_checkpoint``; the handoff loads the
    input layer and body (equal to ``from_jax`` of the JAX trees) and the
    run's ``avg_image.npy``, keeps the output layer, refuses an orbax
    checkpoint and a body of another depth;
  * the reference ``.pt``: a state_dict, bare and under ``state_dict``,
    with the reference's ``encoder.*`` names and other keys, loads the
    input layer and body bit for bit and nothing else;
  * ``train_stage3`` with ``MobileFaceNet`` and ``--remat``: two steps, a
    checkpoint that ``test_rfw --roc_dir`` reads, writing a ROC image.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.utils.checkpoint import (
    load_checkpoint as jload_checkpoint)
from stylegan_for_facerec_tpu.utils.checkpoint import (
    save_checkpoint as jsave_checkpoint)
from stylegan_for_facerec_torch.models import psp
from stylegan_for_facerec_torch.nn.layers import Dropout
from stylegan_for_facerec_torch.tools import test_rfw, train_stage3
from stylegan_for_facerec_torch.train.stage3 import (Stage3Config,
                                                     Stage3Trainer)
from stylegan_for_facerec_torch.utils.checkpoint import read_jax_checkpoint
from stylegan_for_facerec_torch.utils.convert import from_jax
from test_torch_facerec_models import JTinyPSpFaceRec, perturbed, tiny_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "stage3_bupt_ir50.json")
ACCEPTED = ("pSp", "MobileFaceNet", "IR_50", "IR_101", "IR_152",
            "IR_SE_50", "IR_SE_101", "IR_SE_152", "ResNet_50", "ResNet_101",
            "ResNet_152")
REFUSED = ("VGG16", "ResNet_18", "IR_34", "IR_SE_18", "mobilefacenet",
           "GhostNet", "EfficientNetB0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_stage3", os.path.join(REPO, "tools", "train_stage3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Opts:
    input_size = (112, 112)
    emb_size = 512
    dropout = 0.15

    def __init__(self, name):
        self.backbone = name


def test_build_backbone_accepts_and_refuses_as_jax():
    jcli = _jax_cli()
    with torch.device("meta"):            # layouts only, no weights drawn
        for name in ACCEPTED:
            assert jcli.build_backbone(_Opts(name), 10) is not None, name
            m = train_stage3.build_backbone(_Opts(name))
            assert type(m).__name__ == type(
                jcli.build_backbone(_Opts(name), 10)).__name__, name
    for name in REFUSED:
        with pytest.raises(SystemExit):
            jcli.build_backbone(_Opts(name), 10)
        with pytest.raises(SystemExit):
            train_stage3.build_backbone(_Opts(name))
    assert set(train_stage3.BACKBONES) == set(ACCEPTED)
    with torch.device("meta"):
        r50 = train_stage3.build_backbone(_Opts("ResNet_50"))
        psp_ = train_stage3.build_backbone(_Opts("pSp"))
    assert r50.dropout.p == 0.5                    # the JAX CLI's default
    assert {m.p for m in psp_.modules() if isinstance(m, Dropout)} >= {0.15}


# -- remat -------------------------------------------------------------------

def _remat_trainer(remat):
    bb = psp.PSpFaceRec(size=32, emb_size=64, block_dropout=0.15)
    tiny_port(bb, bb.encoder, dropout=0.15)
    for m in bb.modules():                         # tiny_port sets p = 0
        if isinstance(m, Dropout):
            m.p = 0.15 if m is not bb.encoder.output_layer[1] else 0.5
    return Stage3Trainer(bb, Stage3Config(
        emb_size=64, num_classes=64, batch_size=8, compute_dtype="float32",
        remat=remat, stages=(1,)), steps_per_epoch=2, device="cpu", seed=0)


def test_remat_step_equals_the_step_without_it():
    plain, remat = _remat_trainer(False), _remat_trainer(True)
    calls = {"plain": 0, "remat": 0}
    for name, t in (("plain", plain), ("remat", remat)):
        t.backbone.encoder.input_layer.register_forward_hook(
            lambda *_, n=name: calls.__setitem__(n, calls[n] + 1))
    rng = np.random.RandomState(3)
    stats0 = {k: v.clone() for k, v in plain.backbone.state_dict().items()}
    losses = []
    for step in range(2):
        x = torch.from_numpy(rng.uniform(-1, 1, (8, 32, 32, 3)).astype(
            np.float32))
        y = torch.from_numpy(rng.randint(0, 64, 8))
        losses.append([float(t.train_step(x, y, step, t.freeze_mask(False))
                             ["loss"]) for t in (plain, remat)])
    assert losses[0][0] == losses[0][1] and losses[1][0] == losses[1][1]
    assert calls == {"plain": 2, "remat": 4}     # remat recomputed
    a, b = plain.backbone.state_dict(), remat.backbone.state_dict()
    for k in a:
        if k.endswith("num_batches_tracked"):
            assert int(a[k]) == int(b[k]) == 2, k    # one update a step
            continue
        scale = float(a[k].abs().max()) or 1.0
        assert float((a[k] - b[k]).abs().max()) <= 1e-6 * scale, k
        if k.endswith("running_mean"):
            assert not torch.equal(a[k], stats0[k]), k
    torch.testing.assert_close(plain.head_weight, remat.head_weight,
                               rtol=0, atol=1e-6)
    # the same dropout draws: the generators stand at the same state
    assert torch.equal(plain.generator.get_state(),
                       remat.generator.get_state())
    # dropout is live: the same step with a fresh generator seed differs
    other = _remat_trainer(True)
    other.generator.manual_seed(9)
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (8, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(3).randint(0, 64, 8))
    assert float(other.train_step(x, y, 0)["loss"]) != losses[0][0]


# -- the stage-2 handoffs ------------------------------------------------------

def _tiny_port_backbone():
    bb = psp.PSpFaceRec(size=32, emb_size=64)
    tiny_port(bb, bb.encoder)
    return bb


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run directory: step_* checkpoints of {"params", "state",
    "opt_state"} written by the JAX package, and avg_image.npy."""
    root = tmp_path_factory.mktemp("jax_run")
    jm = JTinyPSpFaceRec(size=32, emb_size=64)
    params, state = perturbed(jm, 11)
    state["avg_image"] = np.random.RandomState(12).uniform(
        -1, 1, (32, 32, 3)).astype(np.float32)
    tree = {"params": jax.tree_util.tree_map(jnp.asarray, params),
            "state": jax.tree_util.tree_map(jnp.asarray, state),
            "opt_state": optax.sgd(0.1, momentum=0.9).init(
                jax.tree_util.tree_map(jnp.asarray, params))}
    jsave_checkpoint(str(root / "step_000000001"), tree)
    jsave_checkpoint(str(root / "step_000000002"), tree)
    avg = np.random.RandomState(13).uniform(-1, 1, (32, 32, 3)).astype(
        np.float32)
    np.save(root / "avg_image.npy", avg)
    return root, params, state, avg


def _dict_leaves(tree):
    """Leaves of nested dicts in insertion order (the flatten order)."""
    out = []
    for v in tree.values():
        out += _dict_leaves(v) if isinstance(v, dict) else [v]
    return out


def test_jax_run_directory_reads_leaf_for_leaf(jax_run):
    root, params, state, _ = jax_run
    got = read_jax_checkpoint(str(root))           # newest step_*
    want = jload_checkpoint(str(root / "step_000000002"))
    got_leaves = _dict_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) > 100
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.asarray(w).dtype
    np.testing.assert_array_equal(
        got["params"]["encoder"]["body"]["0"]["res_layer"]["1"]["weight"],
        params["encoder"]["body"]["0"]["res_layer"]["1"]["weight"])
    assert sorted(got) == ["opt_state", "params", "state"]


def test_jax_run_directory_handoff(jax_run):
    root, params, state, avg = jax_run
    bb = _tiny_port_backbone()
    head0 = {k: v.clone() for k, v in
             bb.encoder.output_layer.state_dict().items()}
    got_avg = train_stage3.load_encoder_handoff(bb, str(root))
    np.testing.assert_array_equal(got_avg.numpy(), avg)
    for part in ("input_layer", "body"):
        mod = getattr(bb.encoder, part)
        want = from_jax(mod, params["encoder"][part], state["encoder"][part])
        for k, v in mod.state_dict().items():
            assert torch.equal(v, want[k]), (part, k)
    for k, v in bb.encoder.output_layer.state_dict().items():
        assert torch.equal(v, head0[k]), k


def test_jax_run_directory_refusals(jax_run, tmp_path):
    root, _, _, _ = jax_run
    deeper = psp.PSpFaceRec(size=32, emb_size=64)   # the full IR-SE-50 body
    with pytest.raises(SystemExit, match="body"):
        train_stage3.load_encoder_handoff(deeper, str(root))
    orbax = tmp_path / "step_000000001"
    orbax.mkdir()
    manifest = json.loads((root / "step_000000001" /
                           "manifest.json").read_text())
    (orbax / "manifest.json").write_text(json.dumps(dict(manifest,
                                                         backend="orbax")))
    with pytest.raises(SystemExit, match="orbax"):
        read_jax_checkpoint(str(tmp_path))
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="manifest"):
        read_jax_checkpoint(str(tmp_path / "empty"))


@pytest.mark.parametrize("wrapped", [True, False])
def test_reference_pt_handoff(tmp_path, wrapped):
    """A reference-layout state_dict: ``encoder.input_layer.*`` and
    ``encoder.body.*`` load bit for bit; the styles, the decoder, the
    output layer's keys and ``latent_avg`` are not read."""
    src = _tiny_port_backbone()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    sd = {f"encoder.{k}": v for k, v in src.encoder.state_dict().items()}
    sd["encoder.styles.0.convs.0.weight"] = torch.zeros(3)
    sd["decoder.synthesis.b4.const"] = torch.zeros(2)
    ckpt = {"state_dict": sd, "latent_avg": torch.zeros(18, 512),
            "opts": {"output_size": 256}} if wrapped else sd
    path = tmp_path / "ref.pt"
    torch.save(ckpt, path)
    bb = _tiny_port_backbone()
    head0 = {k: v.clone() for k, v in
             bb.encoder.output_layer.state_dict().items()}
    assert train_stage3.load_encoder_handoff(bb, str(path)) is None
    for part in ("input_layer", "body"):
        a = getattr(bb.encoder, part).state_dict()
        for k, v in getattr(src.encoder, part).state_dict().items():
            assert torch.equal(a[k], v), (part, k)
    for k, v in bb.encoder.output_layer.state_dict().items():
        assert torch.equal(v, head0[k]), k


# -- the CLIs ----------------------------------------------------------------

def test_cli_trains_a_zoo_backbone_and_test_rfw_writes_roc(tmp_path):
    rng = np.random.RandomState(0)
    for ident in ("a1", "b2", "c3"):
        (tmp_path / "faces" / ident).mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.randint(0, 256, (120, 120, 3), np.uint8)
                            ).save(tmp_path / "faces" / ident / f"{j}.png")
    images = (rng.randint(0, 256, (20, 112, 112, 3)) / 127.5 - 1).astype(
        np.float32)
    images[1] = images[0]
    np.savez(tmp_path / "rfw_African.npz", images=images,
             issame=np.arange(10) < 1)
    cfg = dict(json.load(open(CONFIG)), backbone="MobileFaceNet",
               data_root=str(tmp_path), train_subdir="faces",
               model_root=str(tmp_path / "runs"), name="mfn", batch_size=2,
               num_epochs=1, freeze_backbone_epochs=1, stages=[2],
               eval_benchmarks=[], emb_size=64)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    train_stage3.main(["--config", str(tmp_path / "cfg.json"),
                       "--max_steps", "2", "--device", "cpu",
                       "--compute_dtype", "float32", "--remat"])
    ckpts = sorted(os.listdir(tmp_path / "runs" / "mfn"))
    assert ckpts[0] == "logs" and ckpts[-1] == "step_000000002.pt"
    ck = str(tmp_path / "runs" / "mfn" / ckpts[-1])
    sd = torch.load(ck, weights_only=True)["backbone"]
    assert "conv_6_dw.conv.weight" in sd
    res = test_rfw.main(["--checkpoint", ck, "--data_root", str(tmp_path),
                         "--benchmarks", "rfw_African", "--backbone",
                         "MobileFaceNet", "--emb_size", "64", "--batch_size",
                         "20", "--no_tta", "--device", "cpu", "--roc_dir",
                         str(tmp_path / "roc")])
    assert 0.0 <= res["rfw_African"][0] <= 1.0
    roc = tmp_path / "roc" / "rfw_African_ROC_Curve" / "0000.jpg"
    img = np.asarray(Image.open(roc))
    assert img.ndim == 3 and img.shape[2] == 3 and img.std() > 0
    lines = (tmp_path / "roc" / "metrics.jsonl").read_text().splitlines()
    assert "rfw_African_Accuracy" in json.loads(lines[0])
