"""StyleGAN2-ADA smooth 2x upsample: nearest x2, replication pad (2,1,2,1),
[1,3,3,1]/8 blur on both axes. NCHW.

``smooth_upsample`` on a CUDA tensor launches kernel B2
(``csrc/smooth_upsample.cu``), which replaces the Pallas kernel ``_kernel``
of ``stylegan_for_facerec_tpu/ops/upfirdn_pallas.py::smooth_upsample_pallas``.
On a CPU tensor it runs ``smooth_upsample_plain``, the literal reference
sequence. B2 is bound by memory: it moves 5 * numel_in * elem bytes (one
read, a 4x larger write) and never stores the 4x nearest-upsampled tensor
that the plain version makes and pads.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

_K1D = (1.0 / 8, 3.0 / 8, 3.0 / 8, 1.0 / 8)


def smooth_upsample_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), computed in x's dtype."""
    c = x.shape[1]
    k = torch.tensor(_K1D, dtype=x.dtype, device=x.device)
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    x = F.pad(x, (2, 1, 2, 1), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, 4, 1).expand(c, 1, 4, 1), groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, 4).expand(c, 1, 1, 4), groups=c)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("smooth_upsample").sgfr_smooth_upsample
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smooth_upsample(x: torch.Tensor) -> torch.Tensor:
    """The semantics of ``smooth_upsample_plain``; kernel B2 on a CUDA
    tensor (contiguous NCHW, f32 or bf16, any C, H, W >= 1), the plain
    version on a CPU one. ``smooth_upsample.launches`` counts the kernel's
    launches."""
    if x.device.type == "cpu":
        return smooth_upsample_plain(x)
    code = build.check_input("smooth_upsample", x)
    if x.dim() != 4 or x.shape[2] < 1 or x.shape[3] < 1:
        raise ValueError(f"smooth_upsample: needs (N, C, H, W) with H, W >= "
                         f"1, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = _entry()(x.data_ptr(), y.data_ptr(), n * c, h, w, code,
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error("smooth_upsample", rc)
    smooth_upsample.launches += 1
    return y


smooth_upsample.launches = 0
