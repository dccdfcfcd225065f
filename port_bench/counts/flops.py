"""Work of one call of each entry, counted on the plain reference.

The FLOPs are what ``torch.utils.flop_counter.FlopCounterMode`` counts
over the reference's call on the meta device at the cell's shapes
(convolutions, matrix products, forward and backward): a function of the
configuration and the traffic alone, so that it reads the same work
whatever implements it. The bytes of the port's B1 (``bias_act``) and B2
(``smooth_upsample``) calls are those of the reference's own calls of
the same operations, each input read once and each output written once.
"""

from __future__ import annotations

import functools
import json
import math
from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.facerec import (FaceRecNet, Run, arcface_ce,
                                          focal_of_mean)
from port_bench.reference.ops import Precision
from port_bench.reference.restyle import ReStyle

META = torch.device("meta")


def _key(cfg: dict) -> str:
    return json.dumps(cfg, sort_keys=True)


@functools.lru_cache(maxsize=8)
def _train_step_flops(cfg_key: str, batch: int) -> int:
    cfg = json.loads(cfg_key)
    with torch.device(META):
        net = FaceRecNet(cfg["input_size"], cfg["num_layers"],
                         cfg["emb_size"], cfg["dropout"]).train()
        head = torch.zeros(cfg["num_classes"], cfg["emb_size"],
                           requires_grad=True)
        s = cfg["input_size"]
        images = torch.zeros(batch, s, s, 3, dtype=torch.uint8)
        labels = torch.zeros(batch, dtype=torch.long)
    prec = Precision("fp32")
    with FlopCounterMode(display=False) as fc:
        feats = net(images, Run(prec, None, True))
        ce = arcface_ce(feats, head, labels, cfg["arcface_s"], cfg["margin"],
                        prec).mean()
        focal_of_mean(ce).backward()
    return fc.get_total_flops()


def train_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one stage-3 step (forward and backward) at ``batch``."""
    return _train_step_flops(_key(cfg), batch)


def _inversion(cfg: dict, batch: int, tally=None):
    with torch.device(META):
        model = ReStyle(cfg).eval().requires_grad_(False)
        s = cfg["input_size"]
        x = torch.zeros(batch, s, s, 3)
        avg = torch.zeros(s, s, 3)
        lat = torch.zeros(model.n_styles, cfg["w_dim"])
    model.kernel_calls(tally)
    return lambda: model.invert(x, avg, lat, cfg["n_iters"],
                                Precision("fp32"))


@functools.lru_cache(maxsize=8)
def _inversion_flops(cfg_key: str, batch: int) -> int:
    run = _inversion(json.loads(cfg_key), batch)
    with FlopCounterMode(display=False) as fc:
        run()
    return fc.get_total_flops()


def inversion_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one ``run_on_batch`` call (``n_iters`` iterations)."""
    return _inversion_flops(_key(cfg), batch)


def kernel_calls(cfg: dict, batch: int) -> List[Tuple[str, tuple]]:
    """(kernel, input shape) of every B1 and B2 call of one inversion."""
    tally: List[Tuple[str, tuple]] = []
    _inversion(cfg, batch, tally)()
    return tally


def kernel_work(kernel: str, shape: tuple, elem_bytes: int):
    """(bytes, FLOPs) one call needs: B1 reads x and the bias and writes y
    (add, select, scale, clamp: 4 operations an element); B2 reads x and
    writes the 4x larger output (two 4-tap filters: 16 operations an
    output element)."""
    n = math.prod(shape)
    if kernel == "bias_act":
        return (2 * n + shape[1]) * elem_bytes, 4 * n
    if kernel == "smooth_upsample":
        return 5 * n * elem_bytes, 16 * 4 * n
    raise ValueError(kernel)
