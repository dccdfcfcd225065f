"""Host ms of the span ``sgfr.data.wait`` (``data/packed.py::
device_prefetch``, on the consumer's thread: from asking for the next
shipped batch until it is handed over, the queue's get and the stream's
wait queued) a step (``sgfr.stage3.step``) in the traced window."""

from port_bench.harness.spans import per_call

UNIT = "ms"


def read(r):
    return per_call(r, "sgfr.data.wait", "host_ms", "sgfr.stage3.step")
