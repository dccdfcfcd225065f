#!/usr/bin/env python3
"""Peak device memory of each synthesis convolution of the ADA G at 1024²,
whole and as one rank's band of ``parallel/spatial.py`` over two ranks.

    python3 scripts/spatial_memory.py [--batch 4]

For every modulated 3x3 convolution of the generator (z/w 512, the
published widths) it runs ``ops.modconv.modulated_conv2d`` once on seeded
inputs at the shape one process gives it (padding 1) and at the shape a
band gives it (the rank's rows plus the halo rows ``spatial.py`` fetches,
padding (0, 1), and the same rows with padding 1, two rows more out), in
f32 (TF32 off) and bf16, and prints the peak bytes allocated above the
inputs and output of each call: the modulated input and what the
convolution takes for itself (cuDNN's workspace). Then one JSON line and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stylegan_for_facerec_torch.models.stylegan2_ada import (  # noqa: E402
    Generator)
from stylegan_for_facerec_torch.ops.modconv import modulated_conv2d  # noqa


def conv_peak(shape, out_ch: int, padding, dtype) -> float:
    """MiB allocated above the inputs and the output by one call."""
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.randn((out_ch, shape[1], 3, 3), generator=gen, device="cuda")
    s = torch.randn((shape[0], shape[1]), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = modulated_conv2d(x, w, s, padding=padding)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return (peak - y.numel() * y.element_size()) / 2 ** 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = Generator(512, 512, 8, 1024).synthesis
    layers = [net.first_block.conv1] + [c for b in net.blocks
                                        for c in (b.conv0, b.conv1)]
    rows = []
    for layer in layers:
        r, n = layer.resolution, args.batch
        r_in = r // 2 if layer.up else r
        cin, cout = layer.weight.shape[1], layer.weight.shape[0]
        # a band's conv rows: the rank's r / 2 rows, or the r / 4 + 2 rows
        # B2 reads for them; one halo row each side of those
        band = (r_in // 2 + 2 if layer.up else r // 2) + 2
        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            whole = conv_peak((n, cin, r_in, r_in), cout, 1, dtype)
            part = conv_peak((n, cin, band, r_in), cout, (0, 1), dtype)
            sym = conv_peak((n, cin, band, r_in), cout, 1, dtype)
            rows.append({"resolution": r, "up": layer.up, "in": cin,
                         "out": cout, "dtype": dname,
                         "whole_shape": [n, cin, r_in, r_in],
                         "band_shape": [n, cin, band, r_in],
                         "whole_mib": whole, "band_mib": part,
                         "band_padding1_mib": sym})
            print(f"{r:5d} {'up' if layer.up else '  '} {cin:4d}->{cout:4d} "
                  f"{dname:5s} whole {whole:10.1f} MiB  band "
                  f"{part:10.1f} MiB  band, padding 1 {sym:10.1f} MiB",
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"conv_workspace": rows}))
    print(smi[0] if smi else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
