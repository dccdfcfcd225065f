"""100 x (1 - union of the device's kernel, copy and set intervals /
traced window), from torch.profiler over the traced calls (rank 0's
card)."""

UNIT = "%"


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
