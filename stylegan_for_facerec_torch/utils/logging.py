"""Training logs: ``AverageMeter``, ``aggregate_loss_dicts``,
``MetricLogger`` (scalars as JSON lines, per-benchmark verification
results with their ROC curves, images as JPEG), ``render_roc_curve`` and
``profile_trace`` (a ``torch.profiler`` Chrome trace with the port's
spans, and their summary), as the JAX package's ``utils/logging.py``
without its wandb backend and its ``StepTimer`` (the port times its
layers in ``utils/tracing.py``)."""

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
    ``log_dir/<name>/[<subscript>_]<step>.jpg``. Close it (or use it as a
    context manager) to close the file."""

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

    def log_image(self, name: str, image, step: int,
                  subscript: Optional[str] = None) -> Optional[str]:
        """Save ``image`` (a uint8 HWC array or a PIL image) as
        ``log_dir/<name>/<subscript>_<step:04d>.jpg``, or
        ``<step:04d>.jpg`` without a subscript: the JAX package's layout.
        Returns the written path (None without a log_dir)."""
        if not self.log_dir:
            return None
        from PIL import Image
        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        fname = (f"{subscript}_{step:04d}.jpg" if subscript
                 else f"{step:04d}.jpg")
        path = os.path.join(self.log_dir, name, fname)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        image.save(path)
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
    for Perfetto or chrome://tracing) into ``log_dir``: CPU activity, the
    port's ``sgfr.*`` spans, and the card's kernels when ``device`` is a
    CUDA device. Beside it, ``spans_<pid>_<ns>.json`` holds
    ``utils.tracing.summary()`` of the block (the spans are reset as it
    opens). With ``enabled=False`` it does nothing. Yields the profiler
    (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import tracing

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    tracing.reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    stem = f"{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, "trace_" + stem))
    with open(os.path.join(log_dir, "spans_" + stem), "w") as f:
        json.dump(tracing.summary(), f, indent=1)
