"""The harness on the CPU: a whole run with a stub entry prints the last
line a caller reads; a run without a card, and a run that loaded JAX,
print no result; the trace reduction and the percentile on known
numbers."""

import json
import sys
import time
import types

import pytest
import torch

from port_bench import run
from port_bench.harness import core, trace, window
from port_bench.harness.core import Cell


class FakeEvent:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class StubEntry:
    items_per_call, trace_calls, first_call = 8, 2, 0
    flops_per_call, kernel_bound_s_per_call = 1e9, None

    def call(self, i):
        time.sleep(0.002)

    def failed(self):
        return 0

    def release(self):
        pass

    def check(self):
        return {"gap": 0.5}


@pytest.fixture
def host_timing(monkeypatch):
    monkeypatch.setattr(window.torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(window.torch.cuda, "synchronize",
                        lambda *a, **k: None)


def stub_cell(monkeypatch, limit):
    stub = types.SimpleNamespace(setup=lambda ctx: StubEntry())
    real = core.load_module
    monkeypatch.setattr(core, "load_module", lambda kind, name: stub
                        if kind == "entries" else real(kind, name))
    return Cell("stub", 1, {"compute_dtype": "bfloat16"},
                {"entry": "stub", "traffic": {}, "limits": {"gap": limit}},
                ["setup_s", "train_images_per_s", "step_ms_p95"], [])


@pytest.mark.parametrize("limit,correct", [(1.0, True), (0.1, False)])
def test_last_line(monkeypatch, capsys, host_timing, limit, correct):
    cell = stub_cell(monkeypatch, limit)
    out = core.run_rank(cell, 2 ** 33 + 1, 0.3, False, time.time(),
                        device=torch.device("cpu"))
    core.print_result(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is correct
    assert line["checks"] == {"gap": {"value": 0.5, "limit": limit}}
    assert set(line["metrics"]) == {"setup_s", "train_images_per_s",
                                    "step_ms_p95"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert line["attempted"] > 10
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert captured.err.strip().splitlines()[-1].startswith("check correct")


def test_no_card_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "stage3_train.ir50_arcface", "--seed",
                   "3", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_refuse(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", "stage3_train.ir50_arcface.ddp4",
                   "--seed", "3", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_jax_loaded_prints_no_result(monkeypatch, capsys, host_timing):
    cell = stub_cell(monkeypatch, 1.0)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert core.jax_loaded() == ["jaxlib"]
    with pytest.raises(SystemExit):
        core.run_rank(cell, 1, 0.1, False, time.time(),
                      device=torch.device("cpu"))
    assert capsys.readouterr().out == ""


def test_port_name_is_not_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "stylegan_for_facerec_torch_x",
                        types.ModuleType("stylegan_for_facerec_torch_x"))
    assert "stylegan_for_facerec_tpu" not in core.jax_loaded()


def ev(name, start, end, cuda=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU),
        device_index=0, is_user_annotation=False)


def test_trace_reduction():
    events = [ev(trace.SPAN, 0, 100), ev(trace.SPAN, 100, 200),
              ev("aten::conv", 0, 40), ev("aten::add", 150, 190),
              ev("cudaLaunchKernel", 1, 2), ev("cudaLaunchKernel", 3, 4),
              ev("conv_kernel", 10, 50, True),
              ev("conv_kernel", 40, 70, True),
              ev("ncclDevKernel_AllReduce_Sum", 60, 90, True),
              ev("add_kernel", 160, 180, True)]
    t = trace.reduce_events(events, 2, 0)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(100e-6)      # 10-90 and 160-180
    assert t.launches == 2
    assert t.allreduce_exposed_s == pytest.approx(20e-6)   # 70-90
    assert t.kernel_s["conv_kernel"] == pytest.approx(70e-6)
    gaps = dict(t.idle_gaps)
    assert gaps["aten::conv"] == pytest.approx(10e-6)       # 0-10
    assert gaps["host: none"] == pytest.approx(70e-6)  # 90-160 between ops
    assert gaps["aten::add"] == pytest.approx(20e-6)       # 180-200


def test_trace_window_leaves_out_the_time_between_aligned_calls():
    # two calls, each drained and the ranks met before the next: 120-150
    # is the meeting, outside every call; the launch at 130 is outside too
    events = [ev(trace.SPAN, 0, 100), ev(trace.SPAN, 150, 250),
              ev("cudaLaunchKernel", 5, 6), ev("cudaLaunchKernel", 130, 131),
              ev("cudaLaunchKernel", 155, 156),
              ev("conv_kernel", 10, 120, True),
              ev("ncclDevKernel_AllReduce_Sum", 100, 120, True),
              ev("conv_kernel", 160, 200, True),
              ev("ncclDevKernel_AllReduce_Sum", 200, 230, True)]
    t = trace.reduce_events(events, 2, 0)
    assert t.window_s == pytest.approx(220e-6)      # 0-120 and 150-250
    assert t.busy_s == pytest.approx(180e-6)        # 10-120 and 160-230
    assert t.launches == 2
    assert t.allreduce_exposed_s == pytest.approx(30e-6)    # 200-230
    assert sum(v for _, v in t.idle_gaps) == pytest.approx(40e-6)


def test_traced_reads_only_the_calls_after_the_profilers_warmup(
        monkeypatch):
    made, met, seen = [], [], {}
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda *a: None)

    def reduce(events, calls, device_index):
        seen["spans"] = [e for e in events if e.name == trace.SPAN]
        return calls

    monkeypatch.setattr(trace, "reduce_events", reduce)
    assert trace.traced(made.append, 3, 10, 0,
                        before=lambda: met.append(1), warmup=2) == 3
    assert made == [10, 11, 12, 13, 14]
    assert len(met) == 5
    assert len(seen["spans"]) == 3


@pytest.mark.parametrize("sleep,ok", [(0.0, True), (30.0, False)])
def test_launch_waits_for_every_rank_and_ends_a_stuck_one(sleep, ok):
    def argv(rank):
        return [sys.executable, "-c",
                f"import time; time.sleep({sleep} * {rank}); "
                f"print('rank', {rank})"]
    t0 = time.time()
    codes, out = core.launch(argv, 3, t0 + 5.0)
    assert time.time() - t0 < 20
    assert out.decode().strip() == "rank 0"
    assert (not any(codes)) is ok
    assert all(c is not None for c in codes)


def test_trace_without_device_time_raises():
    with pytest.raises(RuntimeError):
        trace.reduce_events([ev(trace.SPAN, 0, 10)], 1, 0)


def test_p95():
    mod = core.load_module("metrics", "step_ms_p95")
    r = types.SimpleNamespace(call_ms=[float(i) for i in range(1, 101)])
    assert mod.read(r) == pytest.approx(95.05)
