"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU
at a tiny size against the cells' own limits, once for each fault a cell
can have (a step that leaves its state unchanged, half of the batch left
out, the exchange between ranks left out, an answer altered where it is
produced). The program as it is comes out correct."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench.harness import core, window
from port_bench.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def host_timing(monkeypatch):
    monkeypatch.setattr(window.torch.cuda, "Event", tiny.HostEvent)
    monkeypatch.setattr(window.torch.cuda, "synchronize",
                        lambda *a, **k: None)


def run(name, variant, seed=2 ** 35 + 9):
    return core.run_rank(tiny.cell(name), seed, 0.1, False, time.time(),
                         variant=variant, device=torch.device("cpu"))


@pytest.mark.parametrize("name,variant", [
    ("stage3_train.ir50_arcface", None),
    ("stage3_train.ir50_arcface", "unchanged_state"),
    ("stage3_train.ir50_arcface", "half_batch"),
    ("inversion.restyle_ir50_ada128", None),
    ("inversion.restyle_ir50_ada128", "unchanged_state"),
    ("inversion.restyle_ir50_ada128", "half_batch"),
    ("inversion.restyle_ir50_ada128", "altered_answer"),
])
def test_fault(name, variant):
    out = run(name, variant)
    assert out["correct"] is (variant is None), out["checks"]


@pytest.mark.parametrize("variant", [None, "no_exchange"])
def test_ddp_fault(variant):
    """Four gloo processes stand in for the four cards."""
    cmd = [sys.executable, os.path.join(HERE, "ddp_rank.py"),
           f"tcp://localhost:{core.free_port()}", variant or "program"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][-3000:]
    line = [x for x in outs[0].splitlines() if x.startswith("{")][-1]
    result = json.loads(line)
    assert result["correct"] is (variant is None), result["checks"]
