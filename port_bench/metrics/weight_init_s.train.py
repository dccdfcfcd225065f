"""Host seconds of ``Stage3Trainer.init`` in this process (rank 0): the
weights drawn on the CPU and moved to the card, the counter
``sgfr.setup.weight_init_s``; part of ``setup_s``."""

from port_bench.harness.spans import counter

UNIT = "s"


def read(r):
    return counter("sgfr.setup.weight_init_s")
