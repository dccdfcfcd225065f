"""Cells cut to a size the CPU tests can hold (the harness's CPU path is
for these tests alone), and host timing in place of CUDA events."""

import json
import time

from port_bench.harness import core
from port_bench.harness.core import Cell

SHRINK = {
    "stage3_train.ir50_arcface": (
        {"num_classes": 64, "compute_dtype": "float32"},
        {"batch_per_chip": 4, "pool": 3, "warmup_steps": 1}),
    "stage3_train.ir50_arcface.ddp4": (
        {"num_classes": 64, "compute_dtype": "float32"},
        {"batch_per_chip": 2, "pool": 3, "warmup_steps": 1}),
    "inversion.restyle_ir50_ada128": (
        {"output_size": 32, "n_iters": 2, "n_latent": 256,
         "compute_dtype": "float32"},
        {"batch": 2, "pool": 3, "checked_batches": 2, "warmup_calls": 3}),
}


def cell(name: str) -> Cell:
    """The cell with its configuration and traffic cut down, its limits
    as they are."""
    c = core.find_cell(name)
    cfg, traffic = SHRINK[name]
    spec = json.loads(json.dumps(c.spec))
    spec["traffic"].update(traffic)
    return Cell(c.name, c.chips, dict(c.config, **cfg), spec, c.end_to_end,
                c.per_layer)


class HostEvent:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3
