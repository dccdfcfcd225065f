"""Training logs: ``AverageMeter``, ``aggregate_loss_dicts``,
``MetricLogger`` (scalars as JSON lines, per-benchmark verification
results with their ROC curves, image grids as PNG), ``render_roc_curve``,
``profile_trace`` (a ``torch.profiler`` Chrome trace) and ``StepTimer``,
as ``stylegan_for_facerec_tpu/utils/logging.py`` without its wandb
backend."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def aggregate_loss_dicts(agg_list: List[Dict]) -> Dict[str, float]:
    """Mean per key over a list of loss dicts."""
    acc = defaultdict(list)
    for d in agg_list:
        for k, v in d.items():
            acc[k].append(float(v))
    return {k: sum(v) / len(v) for k, v in acc.items()}


class MetricLogger:
    """Console lines plus ``log_dir/metrics.jsonl``; ``log_image`` writes
    ``log_dir/<name>/<step>.png``. Close it (or use it as a context
    manager) to close the file."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def log(self, step: int, metrics: Dict, prefix: str = ""):
        payload = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        payload["step"] = int(step)
        payload["time"] = time.time()
        if self._file:
            self._file.write(json.dumps(payload) + "\n")
            self._file.flush()
        line = " ".join(f"{k} {v:.5g}" for k, v in payload.items()
                        if k not in ("step", "time"))
        print(f"[step {step}] {line}", flush=True)

    def log_benchmark(self, step: int, db_name: str, acc: float,
                      best_threshold: float, epoch: Optional[int] = None,
                      roc=None):
        """A verification benchmark's accuracy and best threshold, as
        ``<db_name>_Accuracy`` and ``<db_name>_Best_Threshold``; with
        ``roc`` (tpr, fpr) also its ROC curve, rendered as the image
        ``<db_name>_ROC_Curve`` (needs matplotlib)."""
        payload = {f"{db_name}_Accuracy": acc,
                   f"{db_name}_Best_Threshold": best_threshold}
        if epoch is not None:
            payload["epoch"] = epoch
        self.log(step, payload)
        if roc is not None:
            tpr, fpr = roc
            self.log_image(f"{db_name}_ROC_Curve",
                           render_roc_curve(fpr, tpr), step)

    def log_image(self, name: str, image, step: int) -> Optional[str]:
        """``image``: uint8 HWC array. Returns the written path (None
        without a log_dir)."""
        if not self.log_dir:
            return None
        from PIL import Image
        path = os.path.join(self.log_dir, name, f"{step:04d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(np.asarray(image)).save(path)
        return path

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def render_roc_curve(fpr, tpr) -> np.ndarray:
    """The ROC curve plotted as a uint8 (H, W, 3) image. matplotlib is
    imported here, so nothing else of this package needs it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure()
    try:
        plt.xlabel("FPR", fontsize=14)
        plt.ylabel("TPR", fontsize=14)
        plt.title("ROC Curve", fontsize=14)
        plt.plot(np.asarray(fpr), np.asarray(tpr), linewidth=2)
        fig.canvas.draw()
        return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    finally:
        plt.close(fig)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True, device: str = "cuda"):
    """Profile the block and write a Chrome trace (``trace_<pid>_<ns>.json``,
    for Perfetto or chrome://tracing) into ``log_dir``: CPU activity, and
    the card's kernels when ``device`` is a CUDA device. With
    ``enabled=False`` it does nothing. Yields the profiler (None when
    disabled)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Host wall-clock per step with an EMA, for throughput reporting
    (end a step with ``torch.cuda.synchronize()`` to time the card)."""

    def __init__(self, beta: float = 0.9):
        self.beta = beta
        self.ema = None
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t
        self.ema = dt if self.ema is None else \
            self.beta * self.ema + (1 - self.beta) * dt
        return dt
