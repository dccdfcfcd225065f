"""The threaded C++ JPEG/PNG loader (``native/fastloader.cpp``) behind
ctypes, as ``stylegan_for_facerec_tpu/data/native_loader.py``.

The library is built with ``g++ -O3 -march=native -shared`` at first use,
linked against libjpeg and libpng (a JPEG-only build where libpng is
missing), into the git-ignored ``ops/build/`` under a name that holds a
hash of the source and one of the host (its CPU, its g++ and the sonames
of libjpeg and libpng), so neither a changed source nor a checkout copied
to another machine reuses a library built for something else. It is a host
library, not a device kernel: ``make_loader`` hands a dataset to the
Python ``DataLoader`` when it cannot be built, when a file is neither
JPEG nor PNG (or PNG on a JPEG-only build), or when a per-image transform
is set, and prints why.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import platform
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

from .dataset import DataLoader, FacesDataset

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "native", "fastloader.cpp")
_CACHE = os.path.join(_HERE, "..", "ops", "build")
NATIVE_EXTS = (".jpg", ".jpeg", ".png")

_lib = None
_failure: Optional[str] = None      # why the last build failed


def _host_tag() -> str:
    """A hash of what a ``-march=native`` build linked against libjpeg and
    libpng depends on besides its source: the machine, the CPU's feature
    flags, the g++ version and the two libraries' sonames."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            parts.append(next((ln for ln in f if ln.startswith("flags")),
                              ""))
    except OSError:
        parts.append(platform.processor())
    try:
        parts.append(subprocess.run(["g++", "-dumpfullversion"],
                                    capture_output=True, text=True).stdout)
    except FileNotFoundError:
        parts.append("no g++")
    parts += [str(ctypes.util.find_library(n)) for n in ("jpeg", "png")]
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()[:12]


def _build_library() -> Optional[str]:
    """Path of the built library (built now if missing), or None when
    g++, libjpeg's headers or its library are missing; the reason is kept
    for ``status``."""
    global _failure
    os.makedirs(_CACHE, exist_ok=True)
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    so_path = os.path.join(_CACHE, f"libfastloader-{tag}-{_host_tag()}.so")
    if os.path.exists(so_path):
        return so_path
    # a process-unique name, renamed into place: test workers and threads
    # may build at once
    tmp = f"{so_path}.{os.getpid()}.tmp"
    last = ""
    for extra in (["-lpng"], ["-DSGFR_NO_PNG"]):
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp, *extra, "-ljpeg", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except FileNotFoundError as e:
            last = str(e)
            break
        except subprocess.CalledProcessError as e:
            lines = e.stderr.decode(errors="replace").strip().splitlines()
            last = next((ln for ln in lines if "error" in ln),
                        lines[-1] if lines else f"exit {e.returncode}")
            continue
        os.replace(tmp, so_path)
        return so_path
    _failure = f"g++ build failed: {last}"
    return None


def _get_lib():
    """The loaded library, built at the first call; None when the build
    failed (not retried)."""
    global _lib, _failure
    if _lib is None and _failure is None:
        so = _build_library()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:        # e.g. built where another libpng was
            _failure = f"cannot load {os.path.basename(so)}: {e}"
            return None
        lib.fl_create.restype = ctypes.c_void_p
        lib.fl_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int]
        lib.fl_num_batches.restype = ctypes.c_int
        lib.fl_num_batches.argtypes = [ctypes.c_void_p]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32)]
        lib.fl_reset.restype = None
        lib.fl_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.fl_destroy.restype = None
        lib.fl_destroy.argtypes = [ctypes.c_void_p]
        lib.fl_has_png.restype = ctypes.c_int
        lib.fl_has_png.argtypes = []
        _lib = lib
    return _lib


def status() -> str:
    """``built (png yes|no)`` or ``unavailable: <reason>``."""
    lib = _get_lib()
    if lib is None:
        return f"unavailable: {_failure}"
    return f"built (png {'yes' if lib.fl_has_png() else 'no'})"


class NativeDataLoader:
    """``data.dataset.DataLoader``'s contract on C++ threads: yields
    (float32 NHWC in [-1, 1], int32 labels) numpy batches, shuffled each
    epoch from ``seed`` + the epoch counter; a ragged last batch is
    trimmed when ``drop_last`` is off. ``fast_decode`` decodes a large
    JPEG at the coarsest 1/2^k DCT scale that still covers the target
    size, then resizes: much less decode work for large sources, pixels
    slightly off the full decode's."""

    def __init__(self, dataset: FacesDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = True, seed: int = 0,
                 fast_decode: bool = False):
        self._handle = None
        self._lib = _get_lib()
        if self._lib is None:
            raise RuntimeError(f"native loader {status()}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.fast_decode = fast_decode
        self._epoch = 0
        # the library reads these while it runs: kept alive here
        self._labels = np.asarray([dataset.label_of(i)
                                   for i in range(len(dataset))], np.int32)
        paths = [p.encode() for p in dataset.filenames]
        self._paths_arr = (ctypes.c_char_p * len(paths))(*paths)
        self._labels_arr = self._labels.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32))

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        lib = self._lib
        if self._handle is None:
            self._handle = lib.fl_create(
                self._paths_arr, len(self.ds), self._labels_arr,
                self.batch_size, self.ds.image_size, self.num_workers,
                int(self.shuffle), self.seed + self._epoch,
                int(self.drop_last), int(self.fast_decode))
        else:
            lib.fl_reset(self._handle, self.seed + self._epoch)
        self._epoch += 1
        s = self.ds.image_size
        images = np.empty((self.batch_size, s, s, 3), np.float32)
        labels = np.empty((self.batch_size,), np.int32)
        while True:
            # the real item count: a ragged tail is trimmed
            n = lib.fl_next(
                self._handle,
                images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n < 0:
                raise RuntimeError("10 consecutive corrupt samples")
            if n == 0:
                break
            yield images[:n].copy(), labels[:n].copy()

    def close(self):
        if self._handle is not None:
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def make_loader(dataset: FacesDataset, batch_size: int, **kw):
    """``NativeDataLoader`` where it can take ``dataset``, else the Python
    ``DataLoader`` (``fast_decode`` dropped), printing why: the library
    did not build, a file is neither JPEG nor PNG (the C++ decoder would
    count it as corrupt and resample it, skewing the data), PNG files on a
    JPEG-only build, or a per-image transform the C++ side cannot run."""
    why = None
    if getattr(dataset, "transform", None) is not None:
        why = "a per-image transform is set"
    elif not all(f.lower().endswith(NATIVE_EXTS) for f in dataset.filenames):
        why = "a file is neither JPEG nor PNG"
    else:
        lib = _get_lib()
        if lib is None:
            why = status()
        elif not lib.fl_has_png() and any(
                f.lower().endswith(".png") for f in dataset.filenames):
            why = "PNG files and a JPEG-only build"
    if why is None:
        return NativeDataLoader(dataset, batch_size, **kw)
    print(f"[native_loader] Python loader: {why}", flush=True)
    kw.pop("fast_decode", None)
    return DataLoader(dataset, batch_size, **kw)
