"""torch.cuda.max_memory_allocated() over the window, reset as it opens;
the fullest card. It sets the largest batch a user fits."""

UNIT = "GiB"


def read(r):
    return r.window_peak_bytes / 2 ** 30
