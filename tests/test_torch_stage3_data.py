"""The port's stage-3 host side against the JAX package's, on the CPU: the
face image tree (labels, ``Ethnicity^`` stripping, decoding, corrupt
files), the threaded loader's batch order, packed shards written by one
package and read by the other with the same batch order for the same seed,
the prefetch, configuration loading, and the stage-2 -> stage-3 encoder
handoff."""

import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.data import dataset as jdataset
from stylegan_for_facerec_tpu.data import packed as jpacked
from stylegan_for_facerec_tpu.utils import config as jconfig
from stylegan_for_facerec_torch.data import dataset, packed
from stylegan_for_facerec_torch.models.psp import PSp, PSpFaceRec
from stylegan_for_facerec_torch.utils import config
from stylegan_for_facerec_torch.utils.checkpoint import load_stage2_encoder
from stylegan_for_facerec_torch.utils.logging import MetricLogger, StepTimer

REPO_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "stage3_bupt_ir50.json")


@pytest.fixture()
def face_tree(tmp_path):
    """5 identities (two with an ethnicity prefix) of 2-3 images each,
    and one corrupt file."""
    rng = np.random.RandomState(0)
    root = tmp_path / "faces"
    names = ["African^m.01", "Asian^m.02", "id_c", "id_d", "id_e"]
    for i, name in enumerate(names):
        (root / name).mkdir(parents=True)
        for j in range(2 + i % 2):
            Image.fromarray(rng.randint(0, 256, (40, 36, 3), np.uint8)).save(
                root / name / f"{j}.jpg" if j % 2 else
                root / name / f"{j}.png")
    (root / "id_e" / "bad.jpg").write_bytes(b"not an image")
    return str(root)


def test_faces_dataset_matches_jax(face_tree):
    ds, jds = dataset.FacesDataset(face_tree), jdataset.FacesDataset(face_tree)
    assert ds.filenames == jds.filenames and len(ds) == 13
    assert ds.id_list == jds.id_list
    assert "m.01" in ds.id_list and ds.n_identities == 5
    assert [ds.label_of(i) for i in range(len(ds))] == \
        [jds.label_of(i) for i in range(len(jds))]
    for i in range(len(ds)):
        got, want = ds.load(i), jds.load(i)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].shape == (128, 128, 3) and got[1] == want[1]


def test_loader_batch_order_matches_jax(face_tree):
    """Same seed: the same shuffles epoch after epoch, corrupt samples
    replaced by the same resampled index."""
    ds, jds = dataset.FacesDataset(face_tree, 32), \
        jdataset.FacesDataset(face_tree, 32)
    ld = dataset.DataLoader(ds, 4, num_workers=2, seed=7)
    jld = jdataset.DataLoader(jds, 4, num_workers=2, seed=7)
    assert len(ld) == len(jld) == 3
    for _ in range(2):
        got, want = list(ld), list(jld)
        assert len(got) == 3
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
            assert x.dtype == np.float32 and y.dtype == np.int32


@pytest.fixture()
def shards(tmp_path):
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (23, 8, 8, 3), np.uint8)
    labels = rng.randint(0, 4, 23)
    return images, labels


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packed_shards_cross_read_with_the_same_order(tmp_path, shards,
                                                      writer):
    images, labels = shards
    d = str(tmp_path / "packed")
    write = jpacked.write_packed if writer == "jax" else packed.write_packed
    meta = write(d, images, labels, ["a", "b", "c", "d"], shard_size=5)
    assert meta["n_shards"] == 5
    assert packed.is_packed_dir(d) and not packed.is_packed_dir(str(tmp_path))
    ds, jds = packed.PackedTrainDataset(d), jpacked.PackedTrainDataset(d)
    assert len(ds) == 23 and ds.n_identities == 4
    idx = np.array([22, 0, 7, 5, 11, 5])
    np.testing.assert_array_equal(ds.gather(idx), images[idx])
    for drop_last in (True, False):
        ld = packed.PackedLoader(ds, 6, drop_last=drop_last, seed=3)
        jld = jpacked.PackedLoader(jds, 6, drop_last=drop_last, seed=3)
        assert len(ld) == len(jld)
        for _ in range(2):
            got, want = list(ld), list(jld)
            assert len(got) == len(want) == len(ld)
            for (x, y), (jx, jy) in zip(got, want):
                np.testing.assert_array_equal(x, jx)
                np.testing.assert_array_equal(y, jy)
                assert x.dtype == np.uint8 and y.dtype == np.int32


def test_write_packed_checks_its_input(tmp_path, shards):
    images, labels = shards
    with pytest.raises(ValueError, match="uint8"):
        packed.write_packed(str(tmp_path), images.astype(np.float32),
                            labels, [])
    with pytest.raises(ValueError, match="labels"):
        packed.write_packed(str(tmp_path), images, labels[:3], [])


def test_loader_producer_errors_reach_the_consumer(tmp_path, shards):
    images, labels = shards
    packed.write_packed(str(tmp_path), images, labels, ["a"], shard_size=5)
    ds = packed.PackedTrainDataset(str(tmp_path))
    ds.shards[2] = None                       # a shard that cannot be read
    with pytest.raises(RuntimeError, match="producer failed"):
        list(packed.PackedLoader(ds, 6, shuffle=False))


def test_device_prefetch_on_the_cpu(shards):
    images, labels = shards
    batches = [(images[:4], labels[:4]), (images[4:8], labels[4:8])]
    got = list(packed.device_prefetch(iter(batches), "cpu"))
    assert len(got) == 2
    for (x, y), (wx, wy) in zip(got, batches):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.uint8
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(packed.device_prefetch(iter(batches)))


def test_config_loading_matches_jax(tmp_path):
    got = config.load_config(config.Stage3Options, REPO_CONFIG)
    want = jconfig.load_config(jconfig.Stage3Options, REPO_CONFIG)
    for f in config.dataclasses.fields(config.Stage3Options):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dropout == 0.15 and got.freeze_backbone_epochs == 3
    assert tuple(got.stages) == (20, 25, 30, 35, 40, 45, 50, 55, 60, 65)
    y = tmp_path / "c.yaml"
    y.write_text("name: x\nbatch_size: 7\nunknown_key: 1\n")
    assert config.load_config(config.Stage3Options, str(y)).batch_size == 7
    ref = {1: {"NAME": "r", "BATCH_SIZE": 64, "STAGES": [5, 9],
               "NUM_EPOCH": 50, "ENCODER_ADDITIONAL_DROPOUT": 0.2,
               "FREEZE_BACKBONE_EPOCHS": 2, "INPUT_SIZE": [112, 112]}}
    assert config.dataclasses.asdict(config.from_reference_stage3(ref)) == \
        config.dataclasses.asdict(jconfig.from_reference_stage3(ref))
    assert config.from_reference_stage3(ref).warmup_epochs == 2


def test_stage2_encoder_handoff():
    """encoder.input_layer and encoder.body of a stage-2 PSp load strictly
    into PSpFaceRec.encoder; its output layer keeps its weights; another
    body layout is refused."""
    s2 = PSp(output_size=32, input_size=112)
    with torch.no_grad():
        for p in s2.encoder.parameters():
            p.add_(0.01)
    s3 = PSpFaceRec(block_dropout=0.1)
    out_before = {k: v.clone()
                  for k, v in s3.encoder.output_layer.state_dict().items()}
    load_stage2_encoder(s3, s2.state_dict())
    for part in ("input_layer", "body"):
        for (k, v), w in zip(getattr(s2.encoder, part).state_dict().items(),
                             getattr(s3.encoder, part).state_dict().values()):
            assert torch.equal(v, w), k
    for k, v in s3.encoder.output_layer.state_dict().items():
        assert torch.equal(v, out_before[k]), k
    small = PSpFaceRec(num_layers=34)
    with pytest.raises(RuntimeError, match="state_dict"):
        load_stage2_encoder(small, s2.state_dict())


def test_metric_logger_benchmark_and_step_timer(tmp_path):
    with MetricLogger(str(tmp_path)) as logger:
        logger.log_benchmark(12, "rfw_African", 0.875, 1.23, epoch=2)
    line = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert line["rfw_African_Accuracy"] == 0.875
    assert line["rfw_African_Best_Threshold"] == 1.23
    assert line["epoch"] == 2 and line["step"] == 12
    t = StepTimer(beta=0.5)
    t.tic()
    time.sleep(0.01)
    first = t.toc()
    t.tic()
    second = t.toc()
    assert first >= 0.01 and t.ema == pytest.approx(0.5 * first
                                                    + 0.5 * second)
