"""MiB that rank 0 passed to the port's collectives (``parallel/mesh.py``:
every all-reduce and broadcast, the flat tensor's numel x element size)
in the traced window, a step (``sgfr.stage3.step``): the traced tally
of the counter ``sgfr.collective.bytes``."""

from port_bench.harness.spans import per_call

UNIT = "MiB/step"


def read(r):
    sent = per_call(r, "sgfr.collective.bytes", None, "sgfr.stage3.step")
    return None if sent is None else sent / 2 ** 20
