"""CUDA kernel-launch API calls (runtime and low-level) in the traced
window, per call of the entry (rank 0)."""

UNIT = "launches/step"


def read(r):
    if r.trace is None or r.trace.calls == 0:
        return None
    return r.trace.launches / r.trace.calls
