"""On the card: the port's spans and the profiler's kernels share one clock,
and ``profile_trace`` writes the spans into its Chrome trace and their
summary beside it. Run with ``python -m pytest port_bench/tests -q -m
card``."""

import json
import os

import pytest

CELL = "stage3_train.ir50_arcface"
SLACK_US = 50.0


@pytest.fixture(scope="module")
def stage3():
    """The stage-3 cell's entry at its full size, set up (weights, pool,
    the compared and warm-up steps), or None without a card."""
    import torch
    if not torch.cuda.is_available():
        yield None
        return
    from port_bench.harness import core
    ctx = core.Ctx(core.find_cell(CELL), 2 ** 31 + 7, torch.device("cuda", 0))
    entry = core.load_module("entries", "stage3_train").setup(ctx)
    yield entry
    entry.release()


def _kernels_and_launches(events):
    """(kernels [(start, end, correlation id)], {correlation id: launch
    start}) from the profiler's FunctionEvents (microseconds): a kernel
    and the runtime call that launched it share CUPTI's correlation id,
    the events' ``id``."""
    import torch
    from port_bench.harness.trace import LAUNCHES
    kernels, launches = [], {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.time_range.start, e.time_range.end, e.id))
        elif e.name in LAUNCHES:
            launches[e.id] = e.time_range.start
    return kernels, launches


@pytest.mark.card
def test_spans_and_kernels_share_a_clock(card, stage3):
    """Each kernel launched inside a span's host interval runs inside the
    span's event interval, put on the profiler's clock by a marker kernel
    that runs right after a base event: both queue behind a kernel that
    keeps the card busy for some ms, so the host's time between them
    leaves no gap on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stylegan_for_facerec_torch.utils import tracing
    marker = torch.zeros(1, device=card)
    marker.add_(1)              # loaded: its launch follows the base event
    base = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        torch.cuda._sleep(10 ** 7)
        base.record()
        marker.add_(1)
        for i in range(3):
            stage3.call(stage3.first_call + i)
        torch.cuda.synchronize()
    records = sorted((r for r in tracing.spans() if r.start is not None),
                     key=lambda r: r.t0_ns)
    assert [r.name for r in records].count("sgfr.stage3.step") == 3
    events = list(prof.events())
    kernels, launches = _kernels_and_launches(events)
    # the marker: the kernel after the sleep
    anchor = sorted(kernels)[1][0]
    host = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.name.startswith("sgfr."):
            host.setdefault(e.name, []).append(e.time_range)
    seen = {}
    checked = 0
    for r in records:
        k = seen[r.name] = seen.get(r.name, -1) + 1
        lo_h, hi_h = host[r.name][k].start, host[r.name][k].end
        lo_d = anchor + base.elapsed_time(r.start) * 1e3
        hi_d = anchor + base.elapsed_time(r.end) * 1e3
        for s, e, corr in kernels:
            at = launches.get(corr)
            if at is None or not lo_h <= at <= hi_h:
                continue
            checked += 1
            assert lo_d - SLACK_US <= s and e <= hi_d + SLACK_US, (
                r.name, k, s - lo_d, e - hi_d)
    # 3 steps of ~2200 launches, each inside the step and one child span
    assert checked > 3 * 2 * 2000, checked


@pytest.mark.card
def test_profile_trace_writes_the_spans(card, stage3, tmp_path):
    import torch

    from stylegan_for_facerec_torch.utils.logging import profile_trace
    with profile_trace(str(tmp_path), device="cuda"):
        for i in range(2):
            stage3.call(stage3.first_call + 10 + i)
    torch.cuda.synchronize()
    files = sorted(os.listdir(tmp_path))
    (trace,) = [f for f in files if f.startswith("trace_")]
    (spans,) = [f for f in files if f.startswith("spans_")]
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sgfr.stage3.step", "sgfr.stage3.forward",
            "sgfr.stage3.backward", "sgfr.stage3.optimizer"} <= names
    with open(tmp_path / spans) as f:
        summary = json.load(f)
    step = summary["spans"]["sgfr.stage3.step"]
    assert step["count"] == 2 and step["device_ms"] > 0
    parts = sum(summary["spans"][f"sgfr.stage3.{n}"]["device_ms"]
                for n in ("forward", "backward", "optimizer"))
    assert parts == pytest.approx(step["device_ms"], rel=0.03)
