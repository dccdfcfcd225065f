"""The port's tracer (``utils/tracing.py``) on the CPU: off outside a
``torch.profiler`` session, on inside one with the right parents, roots
and traced tallies, and the spans and counters at the port's layer
boundaries (the stage-3 step, ReStyle inversion, the prefetch, the mesh's
collectives) with the benchmark's readers of them."""

import importlib.util
import os
import threading
import types

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from stylegan_for_facerec_torch.data.packed import device_prefetch
from stylegan_for_facerec_torch.eval.inference import run_on_batch
from stylegan_for_facerec_torch.models.psp import PSp
from stylegan_for_facerec_torch.train.stage3 import (Stage3Config,
                                                     Stage3Trainer)
from stylegan_for_facerec_torch.utils import tracing

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
READERS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "grad_sync_ms", "collective_mib_per_step", "encoder_ms.inversion",
           "decoder_ms.inversion", "dispatch_ms.inversion",
           "loader_wait_ms.train", "weight_init_s.train")


@pytest.fixture(autouse=True)
def _fresh_tracer(monkeypatch):
    """Each test on its own tracer, one intra-op thread."""
    monkeypatch.setattr(tracing, "TRACER", tracing.Tracer())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def names():
    return [s.name for s in tracing.spans()]


def test_off_calls_no_record_function_and_keeps_nothing(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    tracing.count("c", 3)
    assert tracing.span("a") is tracing.span("b")
    s = tracing.summary()
    assert s["spans"] == {} and tracing.spans() == []
    assert s["counters"] == {"c": 3} and s["traced_counters"] == {}


def test_on_parents_roots_and_traced_tallies():
    tracing.count("n", 1)
    with recording() as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                tracing.count("n", 2)
            with tracing.span("inner"):
                pass

            def other():
                with tracing.span("thread"):
                    pass

            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with tracing.span("second"):
            pass
    tracing.count("n", 4)
    by = {}
    for s in tracing.spans():
        by.setdefault(s.name, []).append(s)
    outer, second, thread = by["outer"][0], by["second"][0], by["thread"][0]
    assert [s.parent for s in by["inner"]] == [outer.id, outer.id]
    assert [s.root for s in by["inner"]] == [outer.id, outer.id]
    assert outer.parent is None and outer.root == outer.id
    assert second.parent is None and second.root == second.id
    # another thread's stack is its own
    assert thread.parent is None and thread.root == thread.id
    assert all(s.start is None and s.t1_ns >= s.t0_ns
               for s in tracing.spans())
    summ = tracing.summary()
    assert summ["counters"] == {"n": 7}
    assert summ["traced_counters"] == {"n": 2}
    assert summ["spans"]["inner"]["count"] == 2
    o = summ["spans"]["outer"]
    assert o["device_ms"] is None
    inner = sum(s.host_ms for s in by["inner"])
    assert o["self_ms"] == pytest.approx(o["host_ms"] - inner)
    # the CPU profiler records the spans of the thread that opened it
    profiled = {e.name for e in prof.events()}
    assert {"outer", "inner", "second"} <= profiled
    tracing.reset()
    s = tracing.summary()
    assert s["spans"] == {} and s["traced_counters"] == {}
    assert s["counters"] == {"n": 7}


def test_kept_spans_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "TRACER", tracing.Tracer(max_spans=2))
    with recording():
        for _ in range(3):
            with tracing.span("x"):
                pass
    s = tracing.summary()
    assert s["spans"]["x"]["count"] == 2 and s["dropped"] == 1


def tiny_trainer():
    torch.manual_seed(0)
    backbone = nn.Sequential(nn.Conv2d(3, 8, 3, stride=2, padding=1),
                             nn.BatchNorm2d(8), nn.PReLU(8), nn.Flatten(),
                             nn.Linear(8 * 8 * 8, 16))
    cfg = Stage3Config(emb_size=16, num_classes=32, batch_size=4,
                       compute_dtype="float32", freeze_backbone_epochs=0)
    return Stage3Trainer(backbone, cfg, steps_per_epoch=2, device="cpu",
                         seed=3)


def test_stage3_step_spans_and_equal_loss():
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (4, 16, 16, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 32, (4,), generator=g)
    plain = tiny_trainer().train_step(images, labels, 0)["loss"]
    assert tracing.summary()["counters"]["sgfr.setup.weight_init_s"] > 0
    tr = tiny_trainer()
    with recording():
        traced = tr.train_step(images, labels, 0)["loss"]
    assert torch.equal(plain, traced)
    spans = {s.name: s for s in tracing.spans()}
    assert names() == ["sgfr.stage3.forward", "sgfr.stage3.backward",
                       "sgfr.stage3.optimizer", "sgfr.stage3.step"]
    step = spans["sgfr.stage3.step"]
    assert all(s.parent == step.id for s in spans.values() if s is not step)


def test_inversion_spans_in_one_call():
    torch.manual_seed(0)
    model = PSp(output_size=16, input_size=16).eval()
    x = torch.rand(1, 16, 16, 3) * 2 - 1
    avg = torch.zeros(16, 16, 3)
    with recording():
        run_on_batch(model, x, avg, 2)
    s = tracing.summary()["spans"]
    assert s["sgfr.invert.call"]["count"] == 1
    for name in ("sgfr.invert.iteration", "sgfr.invert.resize",
                 "sgfr.psp.encoder", "sgfr.psp.decoder",
                 "sgfr.psp.face_pool"):
        assert s[name]["count"] == 2, name
    (call,) = [r for r in tracing.spans() if r.name == "sgfr.invert.call"]
    assert all(r.root == call.id for r in tracing.spans())


def test_prefetch_waits_once_a_batch():
    batches = [(np.full((2, 3), i, np.uint8), np.arange(2) + i)
               for i in range(3)]
    with recording():
        it = device_prefetch(iter(batches * 2), "cpu", depth=2)
        got = [next(it) for _ in range(3)]
        it.close()
    assert [int(b[0][0, 0]) for b in got] == [0, 1, 2]
    s = tracing.summary()
    assert s["spans"]["sgfr.data.wait"]["count"] == 3
    assert s["counters"]["sgfr.data.batches"] == 3
    assert s["traced_counters"]["sgfr.data.batches"] == 3


def test_sum_grads_counts_one_call_and_its_bytes():
    import torch.distributed as dist

    from stylegan_for_facerec_torch.parallel import mesh as pmesh
    from port_bench.harness.core import free_port
    pmesh.initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                                 backend="gloo")
    try:
        m = pmesh.make_mesh(1, 1, device="cpu")
        params = [nn.Parameter(torch.ones(3, 4)), nn.Parameter(torch.ones(5))]
        for p in params:
            p.grad = torch.ones_like(p)
        with recording():
            m.data.sum_grads_(params)
        s = tracing.summary()
        assert s["traced_counters"]["sgfr.collective.calls"] == 1
        assert s["traced_counters"]["sgfr.collective.bytes"] == 17 * 4
    finally:
        dist.destroy_process_group()


def reader(name):
    path = os.path.join(REPO, "port_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_on_an_empty_summary(name):
    assert reader(name).read(types.SimpleNamespace(trace=object())) is None
