"""Per-label accumulated wall-time profiling.

Analog of the reference's RAII timers (lib/timer.hh:10-90):
``total_timer`` accumulates (calls, seconds) per label into a process-global
map read by :func:`totals`.  PyTorch returns before the card finishes, so
a scope that ran CUDA work synchronises the card at its exit: a stage's time
then covers its device work, not just its enqueue.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

_lock = threading.Lock()
_totals: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])


@contextlib.contextmanager
def total_timer(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with _lock:
            ent = _totals[label]
            ent[0] += 1
            ent[1] += dt


def totals() -> dict[str, tuple[int, float]]:
    with _lock:
        return {k: (int(v[0]), v[1]) for k, v in _totals.items()}


def reset():
    with _lock:
        _totals.clear()
