"""What the port's own tracer (``stylegan_for_facerec_torch/utils/
tracing.py``) recorded in this process: its spans are on only while
``torch.profiler`` records, so after a run with ``--trace 1`` they hold
the traced window's calls (its 2 warm-up calls record nothing), and the
readers of ``metrics/`` read them on rank 0 after the window.

A program without the tracer (a commit before it) gives None, and so
does a span or counter that was not recorded: the reader then reports
nothing.
"""

from __future__ import annotations

from typing import Optional


def summary() -> Optional[dict]:
    try:
        from stylegan_for_facerec_torch.utils import tracing
    except ImportError:
        return None
    return tracing.summary()


def per_call(r, name: str, field: str, call: str) -> Optional[float]:
    """The span ``name``'s ``field`` (``host_ms``, ``device_ms``) or, with
    ``field`` None, the counter ``name``'s traced tally, over the count of
    the span ``call`` in the traced window."""
    s = summary() if r.trace is not None else None
    if s is None or call not in s["spans"]:
        return None
    if field is None:
        value = s["traced_counters"].get(name)
    else:
        value = s["spans"].get(name, {}).get(field)
    n = s["spans"][call]["count"]
    if value is None or n == 0:
        return None
    return value / n


def counter(name: str) -> Optional[float]:
    """The counter's since-start total."""
    s = summary()
    return None if s is None else s["counters"].get(name)
