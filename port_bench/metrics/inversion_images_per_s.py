"""Images inverted in the window (every iteration of each) over the
window's time (host clock, the window closed by a device
synchronisation)."""

UNIT = "images/s"


def read(r):
    return r.items_per_call * r.calls / r.seconds
