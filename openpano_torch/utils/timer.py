"""Per-label accumulated wall-time profiling, and the port's trace spans.

Analog of the reference's RAII timers (lib/timer.hh:10-90):
``total_timer`` accumulates (calls, seconds) per label into a process-global
map read by :func:`totals` and printed by :func:`report`; ``guarded_timer``
prints a scope's duration at its exit.  PyTorch returns before the card
finishes, so a scope that ran CUDA work synchronises the card at its exit:
a stage's time then covers its device work, not just its enqueue.

:class:`span` marks a stage or substage in a ``torch.profiler`` trace as a
``record_function`` range named ``openpano:<name>``, on the clock of the
trace's device events.  A stitch opens one around itself
(``openpano:stitch``), ``total_timer`` one around each timed stage, and
the stages one around each substage, so that a trace of a stitch
(``torch.profiler.profile``, ``export_chrome_trace``) shows where the host
was when it launched, waited or left the card idle.  With no profiler
running a span only checks that and does nothing else.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

_lock = threading.Lock()
_totals: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])


PREFIX = "openpano:"   # the name of every span in a trace starts with it


class span:
    """``with span(name, args):`` a ``record_function`` range
    ``openpano:<name>`` (``args``: a string the trace shows with it) while
    a profiler runs; nothing otherwise.  A bare ``record_function`` costs
    about 10 us an entry and exit with no profiler, this check under 1 us,
    which a panorama's few hundred spans make negligible."""

    __slots__ = ("_range",)

    def __init__(self, name: str, args: str | None = None):
        self._range = (torch.profiler.record_function(PREFIX + name, args)
                       if torch.autograd._profiler_enabled() else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)


@contextlib.contextmanager
def total_timer(label: str):
    """Time the scope under ``label`` (waiting for the card at its end),
    inside the span ``label``, which holds that wait too."""
    with span(label):
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
