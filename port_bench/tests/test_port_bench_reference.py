"""The plain references against the port at tiny sizes on the CPU, in
float32: the stage-3 step (trunk, block dropout with the trainer's
masks, ArcFace, focal loss, SGD) and ReStyle inversion (encoder, the
generator with B1/B2's plain arithmetic, the carried latent), compared by
the same numbers a run compares."""

import torch

from port_bench.harness.core import Ctx
from port_bench.tests import tiny


def run_check(name, seed):
    c = tiny.cell(name)
    from port_bench.harness import core
    entry = core.load_module("entries", c.spec["entry"]).setup(
        Ctx(c, seed, torch.device("cpu")))
    for i in range(entry.first_call,
                   entry.first_call + c.spec["traffic"]["pool"]):
        entry.call(i)
    entry.release()
    return entry.check()


def test_stage3_step_matches_the_port():
    gaps = run_check("stage3_train.ir50_arcface", 2 ** 40 + 3)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_norm_gap"] < 1e-4
    # three SGD steps of a batch of 4 in train-mode BatchNorm amplify
    # float32 round-off in the smallest leaves
    assert gaps["change_norm_gap"] < 1e-2


def test_inversion_matches_the_port():
    gaps = run_check("inversion.restyle_ir50_ada128", 2 ** 40 + 4)
    assert gaps["image_gap"] < 1e-5
    assert gaps["latent_gap"] < 1e-5
