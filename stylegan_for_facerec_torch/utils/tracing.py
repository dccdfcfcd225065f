"""The port's one tracer: spans and counters at its layer boundaries, on
``torch.profiler``'s clock.

``span(name)`` is off unless a ``torch.profiler`` session is recording (a
schedule's active steps, or a plain ``profile`` block): off, it returns a
shared null context after one read of torch's own flag, and never calls
``record_function``. On, it enters ``torch.profiler.record_function(name)``,
so the span lands in the profiler's trace beside the kernels it launched;
when the process uses CUDA it also records a timing ``torch.cuda.Event``
pair on the current stream, at entry and at exit. It never synchronizes.
Each span is kept, up to ``MAX_SPANS``, with its name, its id, its parent
(the innermost open span of its thread), its root span's id, its host
start and end (``time.perf_counter_ns``) and its events.

``count(name, n)`` adds ``n`` to a since-start total (always on: one add)
and, while spans are recording, to a tally of the traced part.
``summary()`` synchronizes once and reduces the spans by name: count, host
ms, device ms, self ms (the span's time less what its child spans cover:
device time where the span has events, host time otherwise), with the
counters' totals and traced tallies. ``reset()`` clears the spans and the
traced tallies.

Names are ``sgfr.<layer>.<part>``: ``sgfr.stage3.*`` (``train/stage3.py``),
``sgfr.invert.*`` (``eval/inference.py``), ``sgfr.psp.*``
(``models/psp.py``), ``sgfr.data.*`` (``data/packed.py``),
``sgfr.collective.*`` (``parallel/mesh.py``), ``sgfr.setup.*``.
``utils/logging.py::profile_trace`` writes ``summary()`` beside its Chrome
trace.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 16

_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` session is recording now (False in a
    schedule's warm-up steps, True in its active ones)."""
    return _autograd_profiler._is_profiler_enabled


class SpanRecord:
    """One finished span; ``start`` and ``end`` are CUDA events or None."""

    __slots__ = ("name", "id", "parent", "root", "t0_ns", "t1_ns", "start",
                 "end")

    def __init__(self, name: str, id_: int, parent: Optional[int],
                 root: int):
        self.name, self.id, self.parent, self.root = name, id_, parent, root
        self.t0_ns = self.t1_ns = 0
        self.start = self.end = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self.start is None:
            return None
        return self.start.elapsed_time(self.end)


class _Open:
    """The context of one recorded span."""

    __slots__ = ("tracer", "name", "rec", "fn")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        stack = self.tracer._stack()
        parent = stack[-1] if stack else None
        id_ = next(self.tracer._ids)
        rec = self.rec = SpanRecord(
            self.name, id_, parent.id if parent else None,
            parent.root if parent else id_)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        stack.append(rec)
        if torch.cuda.is_initialized():
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        rec.t0_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.end is not None:
            rec.end.record()
        rec.t1_ns = time.perf_counter_ns()
        self.tracer._stack().pop()
        self.tracer._keep(rec)
        self.fn.__exit__(*exc)
        return False


class Tracer:
    """Spans and counters of one process (the module's functions use the
    one ``TRACER``)."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: List[SpanRecord] = []
        self.dropped = 0
        self.totals: Dict[str, float] = defaultdict(float)
        self.traced: Dict[str, float] = defaultdict(float)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self.dropped += 1

    def span(self, name: str):
        if not recording():
            return _NULL
        return _Open(self, name)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.totals[name] += n
            if recording():
                self.traced[name] += n

    def spans(self) -> List[SpanRecord]:
        """The finished spans kept since the last ``reset``, in the order
        they ended."""
        with self._lock:
            return list(self._spans)

    def summary(self) -> dict:
        """{"spans": {name: {count, host_ms, device_ms, self_ms}},
        "counters": totals, "traced_counters": tallies, "dropped": n}.
        ``device_ms`` is None for a span without events."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        recs = self.spans()
        own = {r.id: (r.device_ms if r.start is not None else r.host_ms)
               for r in recs}
        children: Dict[int, float] = defaultdict(float)
        for r in recs:
            if r.parent is not None:
                children[r.parent] += own[r.id]
        out: Dict[str, dict] = {}
        for r in recs:
            s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                        "device_ms": None, "self_ms": 0.0})
            s["count"] += 1
            s["host_ms"] += r.host_ms
            if r.start is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + own[r.id]
            s["self_ms"] += own[r.id] - children[r.id]
        with self._lock:
            return {"spans": out, "counters": dict(self.totals),
                    "traced_counters": dict(self.traced),
                    "dropped": self.dropped}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.traced.clear()
            self.dropped = 0


TRACER = Tracer()


def span(name: str):
    """A context manager: a recorded span while a ``torch.profiler``
    session records, else a shared null context."""
    return TRACER.span(name)


def count(name: str, n: float = 1) -> None:
    TRACER.count(name, n)


def summary() -> dict:
    return TRACER.summary()


def reset() -> None:
    TRACER.reset()


def spans() -> List[SpanRecord]:
    return TRACER.spans()
