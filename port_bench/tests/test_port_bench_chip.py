"""On the card: the control of each cell comes out not correct at the
cell's own size, on three seeds (``readings.py``'s ``control``: the
float32 reference with fp8-rounded operands for a bf16 training step,
the port's own bf16 path for the float32 inversion). Run with
``python -m pytest port_bench/tests -q -m card`` on a machine with the
cells' cards."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SEEDS = ["2147483659", "3000000077", "4000000093"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["stage3_train.ir50_arcface",
                                      "inversion.restyle_ir50_ada128",
                                      "stage3_train.ir50_arcface.ddp4"])
def test_control_fails(card, workload):
    import torch
    from port_bench.harness import core
    cell = core.find_cell(workload)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{workload} needs {cell.chips} cards")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "readings.py"), "--workload",
         workload, "--seeds", *SEEDS, "--variants", "control"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == len(SEEDS)
    limits = cell.spec["limits"]
    for r in lines:
        over = [k for k, v in r["checks"].items() if v > limits[k]]
        assert over, r
