"""Preemption handling: ``install_preemption_handler()`` turns SIGTERM and
SIGINT into a ``threading.Event``, so a training loop can finish the step
in flight, write a checkpoint tagged ``preempted``, and exit 0; the run
then continues with ``--resume``."""

from __future__ import annotations

import signal
import threading


def install_preemption_handler(
        signals=(signal.SIGTERM, signal.SIGINT)) -> threading.Event:
    """Install handlers that set (and return) a stop event. The loop checks
    ``stop.is_set()`` once per step; the handler never raises, so no
    kernel launch is torn mid-call. Call it from the main thread."""
    stop = threading.Event()

    def _on_signal(signum, frame):
        print(f"[preempt] caught signal {signum}; checkpointing after the "
              "in-flight step", flush=True)
        stop.set()

    for s in signals:
        signal.signal(s, _on_signal)
    return stop
