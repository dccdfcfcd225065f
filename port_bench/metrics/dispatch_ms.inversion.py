"""Host ms of the span ``sgfr.invert.call`` (``eval/inference.py::
encoder_bootstrap``, all its iterations) a call in the traced window
(``perf_counter_ns``): the time Python takes to issue one call, unless
a full launch queue or a synchronisation holds it back."""

from port_bench.harness.spans import per_call

UNIT = "ms"


def read(r):
    return per_call(r, "sgfr.invert.call", "host_ms", "sgfr.invert.call")
