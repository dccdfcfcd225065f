"""One of four gloo ranks of ``test_port_bench_faults.py::test_ddp_fault``:
``python ddp_rank.py <init> <program|fault> <rank>``."""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench.harness import core, window  # noqa: E402
from port_bench.tests import tiny  # noqa: E402

if __name__ == "__main__":
    init, variant, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    torch.set_num_threads(1)
    window.torch.cuda.Event = tiny.HostEvent
    window.torch.cuda.synchronize = lambda *a, **k: None
    out = core.run_rank(tiny.cell("stage3_train.ir50_arcface.ddp4"),
                        2 ** 35 + 9, 0.1, False, time.time(), rank, 4, init,
                        None if variant == "program" else variant,
                        torch.device("cpu"))
    if out is not None:
        print(json.dumps(out), flush=True)
