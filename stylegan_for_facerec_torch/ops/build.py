"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and compiles into its own
shared library for ``sm_90a``. A library is named by a hash of its source
and of the headers the sources share (``csrc/*.cuh``), so an edited source
or header builds anew and an unchanged one is reused. Libraries
go to ``build/`` beside this file (listed in ``.gitignore``); a kernel is
built at its first use, or up front, all sources in parallel, by
``build_all``. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
SOURCES = ("bias_act", "bias_act_grad", "smooth_upsample",
           "smooth_upsample_grad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc`` per
    source, all started together. Returns ``{name: compiler log}`` (the
    ``-Xptxas -v`` register and spill report); raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """Load the library of kernel source ``name``, building it if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the launch plans
    size their grids to fill them."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_input(op: str, x: torch.Tensor, *others: torch.Tensor) -> int:
    """Refuse what the kernels do not take; returns the C dtype code of x.
    Gradients are the autograd Functions' business (``fused_act``,
    ``resample``), which launch the backward kernels."""
    if x.device.type != "cuda":
        raise ValueError(f"{op}: kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{op}: kernel needs a contiguous NCHW tensor")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{op}: operands on {t.device} and {x.device}")
    return _DTYPE_CODES[x.dtype]


def fastdiv(d: int) -> Tuple[int, int]:
    """(magic, shift) for ``csrc/common.cuh``'s ``FastDiv``, which divides
    0 <= n < 2**31 by d as ``(umulhi(n, magic) + n) >> shift``."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"fastdiv: divisor {d} outside [1, 2**31)")
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def raise_on_error(op: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with cudaError {code}")
