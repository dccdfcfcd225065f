"""Rank 0's NCCL all-reduce kernel time that no other kernel on its card
covers, per step, in the traced window."""

UNIT = "ms"


def read(r):
    t = r.trace
    if t is None or t.calls == 0 or not any(
            "nccl" in k.lower() and "allreduce" in k.lower()
            for k in t.kernel_s):
        return None
    return t.allreduce_exposed_s / t.calls * 1e3
