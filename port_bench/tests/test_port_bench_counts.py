"""The benchmark's FLOP and byte counts against hand counts."""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.counts import flops
from port_bench.reference.ops import Precision

FACEREC = {"input_size": 112, "num_layers": 50, "emb_size": 512,
           "num_classes": 28000, "dropout": 0.15, "arcface_s": 64.0,
           "margin": 0.5}
RESTYLE = {"output_size": 128, "input_nc": 6, "encoder_num_layers": 50,
           "input_size": 112, "z_dim": 512, "w_dim": 512,
           "mapping_layers": 8, "channel_base": 16384, "n_iters": 5}


def test_one_conv_forward_and_backward():
    n, ci, co, h, k = 2, 64, 128, 28, 3
    with torch.device("meta"):
        x = torch.zeros(n, ci, h, h, requires_grad=True)
        w = torch.zeros(co, ci, k, k, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        y = Precision("fp32").conv2d(x, w, padding=1)
        y.sum().backward()
    fwd = 2 * n * co * ci * k * k * h * h
    assert fc.get_total_flops() == 3 * fwd   # forward, dx, dw


def test_stage3_step_count_is_three_forwards():
    """~9.7 TFLOP a batch-256 step, as the port's profile counted."""
    two = flops.train_step_flops(FACEREC, 2)
    assert flops.train_step_flops(FACEREC, 8) == 4 * two
    assert 37e9 < two / 2 < 39e9


def test_bias_act_and_smooth_upsample_work():
    assert flops.kernel_work("bias_act", (2, 8, 4, 4), 2) == (
        (2 * 256 + 8) * 2, 4 * 256)
    assert flops.kernel_work("smooth_upsample", (2, 8, 4, 4), 2) == (
        5 * 256 * 2, 64 * 256)


def test_kernel_calls_of_one_inversion():
    """11 B1 (one a synthesis layer) and 10 B2 (five upsampling layers,
    five image skips) an iteration at 128 x 128."""
    calls = flops.kernel_calls(RESTYLE, 4)
    assert sum(k == "bias_act" for k, _ in calls) == 11 * 5
    assert sum(k == "smooth_upsample" for k, _ in calls) == 10 * 5
    widest = max(math.prod(s) for k, s in calls if k == "bias_act")
    assert widest == 4 * 128 * 128 * 128


def test_inversion_count():
    """An iteration of one image: the encoder's ~14 GFLOP (IR-SE-50 at
    112 with six input channels, 14 map2style heads) and the generator's
    ~22.5 (each block's first conv runs at the lower resolution, before
    the upsample)."""
    per_image = flops.inversion_flops(RESTYLE, 1) / RESTYLE["n_iters"]
    assert 35e9 < per_image < 38e9
