"""Device ms of the span ``sgfr.stage3.grad_sync`` (``Stage3Trainer.
_sync_grads``: flatten, the NCCL all-reduce, unflatten) a step
(``sgfr.stage3.step``) in the traced window, rank 0; CUDA events the
span records on the stream, so the all-reduce counts whole, covered by
other work or not."""

from port_bench.harness.spans import per_call

UNIT = "ms"


def read(r):
    return per_call(r, "sgfr.stage3.grad_sync", "device_ms",
                    "sgfr.stage3.step")
