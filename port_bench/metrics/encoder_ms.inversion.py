"""Device ms of the span ``sgfr.psp.encoder`` (``models/psp.py::PSp``:
the IR-SE-50 encoder and the residual step onto the latent), over its
5 iterations, a call (``sgfr.invert.call``) in the traced window; CUDA
events the span records on the stream."""

from port_bench.harness.spans import per_call

UNIT = "ms"


def read(r):
    return per_call(r, "sgfr.psp.encoder", "device_ms", "sgfr.invert.call")
