"""The loader cell (``entries/stage3_loader.py``) on the CPU at a tiny size:
the program as it is comes out correct against its limits and each fault
a training cell can have does not; the shard it packs is gone after the
run; a traced step records the loader's wait, which the cell's reader
reads a step."""

import importlib.util
import json
import os
import tempfile
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench.harness import core, window
from port_bench.harness.core import Cell
from port_bench.tests import tiny

NAME = "stage3_train.ir50_arcface.loader"
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def host_timing(monkeypatch):
    monkeypatch.setattr(window.torch.cuda, "Event", tiny.HostEvent)
    monkeypatch.setattr(window.torch.cuda, "synchronize",
                        lambda *a, **k: None)


@pytest.fixture
def tmpdir_only(monkeypatch, tmp_path):
    """TMPDIR is ``tmp_path``: what the entry leaves there shows."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def cell() -> Cell:
    c = core.find_cell(NAME)
    spec = json.loads(json.dumps(c.spec))
    spec["traffic"].update(batch_per_chip=4, pool=3, warmup_steps=1)
    return Cell(c.name, c.chips, dict(c.config, num_classes=64,
                                      compute_dtype="float32"),
                spec, c.end_to_end, c.per_layer)


@pytest.mark.parametrize("variant", [None, "unchanged_state", "half_batch"])
def test_fault(variant, tmpdir_only):
    out = core.run_rank(cell(), 2 ** 35 + 9, 0.1, False, time.time(),
                        variant=variant, device=torch.device("cpu"))
    assert out["correct"] is (variant is None), out["checks"]
    assert not [f for f in os.listdir(tmpdir_only)
                if f.startswith("port_bench_packed_")]


def test_traced_steps_record_the_loaders_wait(tmpdir_only):
    from stylegan_for_facerec_torch.utils import tracing
    ctx = core.Ctx(cell(), 2 ** 31 + 11, torch.device("cpu"))
    entry = core.load_module("entries", "stage3_loader").setup(ctx)
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(4):           # past the end of an epoch
                entry.call(entry.first_call + i)
    finally:
        entry.release()
    spans = tracing.summary()["spans"]
    assert spans["sgfr.stage3.step"]["count"] == 4
    assert spans["sgfr.data.wait"]["count"] == 4
    path = os.path.join(HERE, "metrics", "loader_wait_ms.train.py")
    spec = importlib.util.spec_from_file_location("loader_wait", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.read(types.SimpleNamespace(trace=object()))
    assert got == pytest.approx(spans["sgfr.data.wait"]["host_ms"] / 4)
    assert not [f for f in os.listdir(tmpdir_only)
                if f.startswith("port_bench_packed_")]
