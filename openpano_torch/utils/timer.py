"""Per-label accumulated wall-time profiling.

Analog of the reference's RAII timers (lib/timer.hh:10-90):
``total_timer`` accumulates (calls, seconds) per label into a process-global
map read by :func:`totals` and printed by :func:`report`; ``guarded_timer``
prints a scope's duration at its exit.  PyTorch returns before the card
finishes, so a scope that ran CUDA work synchronises the card at its exit:
a stage's time then covers its device work, not just its enqueue.
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


@contextlib.contextmanager
def guarded_timer(label: str, verbose: bool = True):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if verbose:
            print(f"[timer] {label}: {dt * 1000:.2f} ms")


def totals() -> dict[str, tuple[int, float]]:
    with _lock:
        return {k: (int(v[0]), v[1]) for k, v in _totals.items()}


def reset():
    with _lock:
        _totals.clear()


def report(stage_totals: dict[str, tuple[int, float]] | None = None) -> str:
    """The totals (``stage_totals``, or this process's), longest first."""
    lines = []
    by_time = sorted((totals() if stage_totals is None else stage_totals
                      ).items(), key=lambda kv: -kv[1][1])
    for label, (cnt, secs) in by_time:
        lines.append(f"{label}: {cnt} calls, {secs:.3f} s total")
    return "\n".join(lines)


def peak_rss_mb() -> float:
    """Peak resident set size of this process in MiB, the in-process analog
    of the reference's external ``src/memusg`` script (memusg:1-15).
    ru_maxrss is KiB on Linux."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
