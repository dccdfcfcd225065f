"""The port's ``tools/tune_stage3.py`` on the CPU: the sweep's rows and
table at a toy size (the ``tiny`` backbone, f32, batch 2, 64 classes),
the JAX tool's arguments, row keys and table header, MFU as FLOPs over
step time over the peak, only an out-of-memory configuration as an error
row, and ``tiny`` loading the JAX tool's ``Tiny`` weights strictly."""

import importlib.util
import json
import os

import jax
import pytest
import torch

from stylegan_for_facerec_torch.tools import tune_stage3
from stylegan_for_facerec_torch.utils.convert import load_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tune_stage3", os.path.join(ROOT, "tools", "tune_stage3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tiny_loads_the_jax_tools_tiny_strictly():
    jm, size = jax_tool().build_backbone("tiny")
    params, state = jm.init(jax.random.key(0))
    model, side = tune_stage3.build_backbone("tiny")
    assert side == size == 32
    load_from_jax(model, params, state)
    assert len(model.body) == len(tune_stage3.TINY_UNITS) == 4


def test_sweep_writes_rows_and_table(tmp_path, capsys):
    out = tmp_path / "tune.md"
    rows = tune_stage3.main(["--model", "tiny", "--device", "cpu",
                             "--batches", "2", "--remat", "0", "1",
                             "--dtypes", "float32", "--num_classes", "64",
                             "--out", str(out)])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == rows
    assert [(r["batch"], r["remat"], r["dtype"]) for r in rows] == [
        (2, False, "float32"), (2, True, "float32")]
    for r in rows:
        assert set(r) == set(tune_stage3.KEYS)
        assert r["tflops_per_step"] > 0 and r["step_ms"] > 0
        assert r["imgs_per_sec"] == pytest.approx(2e3 / r["step_ms"])
        assert r["mfu"] == pytest.approx(
            r["tflops_per_step"] * 1e12 / (r["step_ms"] / 1e3) / 989e12,
            rel=1e-12)
    # remat recomputes the forward: more FLOPs counted a step
    assert rows[1]["tflops_per_step"] > rows[0]["tflops_per_step"]
    lines = out.read_text().splitlines()
    assert lines[0] == ("| batch | remat | dtype | step_ms | imgs_per_sec "
                        "| tflops_per_step | mfu |")
    assert lines[1] == "|" + "---|" * 7 and len(lines) == 4


def test_only_out_of_memory_is_an_error_row(monkeypatch, capsys):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tune_stage3, "measure", oom)
    rows = tune_stage3.main(["--device", "cpu", "--batches", "4096"])
    assert rows == [{"batch": 4096, "remat": False, "dtype": "bfloat16",
                     "error": rows[0]["error"]}]
    assert "out of memory" in rows[0]["error"]

    def broken(*a, **k):
        raise ValueError("not an OOM")

    monkeypatch.setattr(tune_stage3, "measure", broken)
    with pytest.raises(ValueError, match="not an OOM"):
        tune_stage3.main(["--device", "cpu", "--batches", "2"])


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_stage3.main(["--model", "tiny", "--batches", "2"])
