"""Device ms of the span ``sgfr.stage3.forward`` (``train/stage3.py``:
the uint8 cast, the backbone, the margin head, the loss and top-k) a
step (``sgfr.stage3.step``) in the traced window, rank 0; CUDA events
the span records on the stream."""

from port_bench.harness.spans import per_call

UNIT = "ms"


def read(r):
    return per_call(r, "sgfr.stage3.forward", "device_ms",
                    "sgfr.stage3.step")
