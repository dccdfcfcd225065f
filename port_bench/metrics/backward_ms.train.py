"""Device ms of the span ``sgfr.stage3.backward`` (``loss.backward()``
of ``train/stage3.py``) a step (``sgfr.stage3.step``) in the traced
window, rank 0; CUDA events the span records on the stream."""

from port_bench.harness.spans import per_call

UNIT = "ms"


def read(r):
    return per_call(r, "sgfr.stage3.backward", "device_ms",
                    "sgfr.stage3.step")
