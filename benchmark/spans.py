"""The port's spans in one profiled panorama: what the host did under each.

The port opens a ``record_function`` range named ``openpano:<name>`` around
a stitch, each stage and each substage while a profiler runs
(``openpano_torch.utils.timer.span``).  :func:`reduce` takes the
``torch.profiler`` trace of a panorama and gives, for each span name:

- ``count``, and ``incl_s`` / ``self_s``, the host seconds inside its
  ranges with and without the spans nested in them;
- ``busy_s`` / ``idle_s``: the card's busy and idle seconds while the
  span was the innermost one open on the stitch's thread (an idle gap is
  split among the spans it crosses: ``trace.py`` gives a stage's gap
  whole to the stage that holds its midpoint, which at this grain would
  give a gap across many LM iterations to one of them);
- ``launches``: kernel launch calls the host issued (``cudaLaunchKernel``
  and its kin, counted where the host issued them, not where the kernel
  ran); ``syncs``: blocking host synchronisations (stream, device and
  event synchronise, plain ``cudaMemcpy``), ``sync_s`` the host seconds
  spent in them; ``ops``: top-level CPU operators (``aten::`` events inside
  no other ``aten::`` event of their thread);
- each of the last four for the span's own time (innermost open span of
  the event's thread) and, as ``*_incl``, for its time with its nested
  spans;
- ``close_syncs`` / ``close_sync_s``: ranges whose last host event is a
  ``cudaDeviceSynchronize``, the wait a stage timer does as it closes.

What happened under no span goes to the row ``unspanned`` on the stitch's
thread and to ``other threads`` on the rest (the background upload).
Plain torch: it reads nothing of the port.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from benchmark import trace

PREFIX = "openpano:"
STITCH = "stitch"
UNSPANNED = "unspanned"
OTHER = "other threads"
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                   "cuLaunchKernel", "cuLaunchCooperativeKernel")
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy",
                   "cuStreamSynchronize", "cuCtxSynchronize",
                   "cuEventSynchronize"))
CLOSE_SYNC = "cudaDeviceSynchronize"
COUNTED = ("launches", "syncs", "sync_s", "ops")

# the per-layer metrics the spans give: name -> (unit, layer, the span,
# the counter summed under it with its nested spans, whether it is taken
# per range of the span)
METRICS = {
    "features.launches_per_pano": ("launches", "features", "calc_feature",
                                   "launches", False),
    "features.syncs_per_pano": ("syncs", "features", "calc_feature",
                                "syncs", False),
    "match.launches_per_pano": ("launches", "match and RANSAC",
                                "pairwise_match", "launches", False),
    "match.syncs_per_pano": ("syncs", "match and RANSAC", "pairwise_match",
                             "syncs", False),
    "cameras.lm_ops_per_iter": ("ops", "cameras", "cameras.lm_iter", "ops",
                                True),
}


def entries(workloads: list[str]) -> list[dict]:
    """The ``per_layer`` entries of :data:`METRICS`, as ``BENCHMARK.json``
    would list them for ``workloads``."""
    return [{"name": name, "unit": unit, "better": "lower",
             "source": "program_span", "layer": layer, "moves": "pano_s",
             "workloads": list(workloads)}
            for name, (unit, layer, *_) in METRICS.items()]


def metric(rows: dict | None, name: str) -> float | None:
    """The metric ``name`` of :data:`METRICS` from :func:`reduce`'s rows;
    None where its span is absent or its count is zero (no profile, no
    card, or a program without the span)."""
    _, _, span, counter, per_range = METRICS[name]
    row = (rows or {}).get(span)
    if not row or not row[counter + "_incl"]:
        return None
    value = float(row[counter + "_incl"])
    return value / row["count"] if per_range else value


def _row() -> dict:
    row = {"count": 0, "incl_s": 0.0, "self_s": 0.0, "busy_s": 0.0,
           "idle_s": 0.0, "close_syncs": 0, "close_sync_s": 0.0}
    for c in COUNTED:
        row[c] = row[c + "_incl"] = 0 if c != "sync_s" else 0.0
    return row


def _events(prof):
    """Spans [(start, end, name)] and host items [(start, end, kind,
    name)] by host thread, device intervals [(start, end)], and the
    panorama's range (the harness's, else the stitch spans', else the
    trace's extent)."""
    spans, items = defaultdict(list), defaultdict(list)
    device, ops, pano = [], defaultdict(list), []
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                device.append((a, b))
            continue
        tid = e.device_resource_id()
        if name.startswith(PREFIX):
            spans[tid].append((a, b, name[len(PREFIX):]))
        elif name == trace.PANORAMA:
            pano.append((a, b))
        elif name.startswith("aten::"):
            ops[tid].append((a, b))
        elif name in SYNCS:
            items[tid].append((a, b, "sync", name))
        elif name.startswith(LAUNCH_PREFIXES):
            items[tid].append((a, b, "launch", name))
    for tid, lst in ops.items():
        lst.sort(key=lambda iv: (iv[0], -iv[1]))
        top_end = None
        for a, b in lst:
            if top_end is None or a >= top_end:
                items[tid].append((a, b, "op", None))
                top_end = b
    stitches = [(a, b) for lst in spans.values() for a, b, n in lst
                if n == STITCH]
    if pano:
        window = pano[0]
    elif stitches:
        window = (min(a for a, _ in stitches), max(b for _, b in stitches))
    else:
        every = [x for lst in spans.values() for x in lst] + device
        window = ((min(x[0] for x in every), max(x[1] for x in every))
                  if every else (0, 0))
    return spans, items, device, window


def _main_thread(spans) -> int | None:
    """The thread that opened the first stitch span (else the most
    spans)."""
    first = min(((a, tid) for tid, lst in spans.items()
                 for a, _, n in lst if n == STITCH), default=None)
    if first is not None:
        return first[1]
    return max(spans, key=lambda t: len(spans[t]), default=None)


def _nesting(lst):
    """For ranges ``lst`` of one thread sorted by (start, -end), properly
    nested: each one's parent index (or None) and the innermost-range
    segments [(start, end, name)] of the thread's timeline."""
    parent, segments, stack = [], [], []
    cursor = None

    def close_to(t):
        nonlocal cursor
        while stack and lst[stack[-1]][1] <= t:
            end = lst[stack[-1]][1]
            if end > cursor:
                segments.append((cursor, end, lst[stack[-1]][2]))
            cursor = end
            stack.pop()

    for i, (a, _, _) in enumerate(lst):
        close_to(a)
        if stack and a > cursor:
            segments.append((cursor, a, lst[stack[-1]][2]))
        cursor = a
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    close_to(float("inf"))
    return parent, segments


def _host_rows(spans, items, main, rows):
    """Counts, host seconds and the host items of every thread into
    ``rows``; returns the main thread's innermost-span segments."""
    main_segments = []
    for tid in set(spans) | set(items):
        lst = sorted(spans.get(tid, ()), key=lambda s: (s[0], -s[1]))
        parent, segments = _nesting(lst)
        if tid == main:
            main_segments = segments
        none = UNSPANNED if tid == main else OTHER
        child = [0] * len(lst)
        for i, p in enumerate(parent):
            if p is not None:
                child[p] += lst[i][1] - lst[i][0]
        last = {}           # range index -> its last own host item
        stack, k = [], 0
        for a, b, kind, name in sorted(items.get(tid, ())):
            while k < len(lst) and lst[k][0] <= a:
                while stack and lst[stack[-1]][1] <= lst[k][0]:
                    stack.pop()
                stack.append(k)
                k += 1
            while stack and lst[stack[-1]][1] <= a:
                stack.pop()
            counted = {"launch": "launches", "sync": "syncs",
                       "op": "ops"}[kind]
            wait = (b - a) / 1e9 if kind == "sync" else 0.0
            own = rows[lst[stack[-1]][2] if stack else none]
            own[counted] += 1
            own["sync_s"] += wait
            for n in {lst[i][2] for i in stack} or {none}:
                rows[n][counted + "_incl"] += 1
                rows[n]["sync_s_incl"] += wait
            if stack:
                last[stack[-1]] = (a, b, name)
        for i, (a, b, n) in enumerate(lst):
            row = rows[n]
            row["count"] += 1
            row["incl_s"] += (b - a) / 1e9
            row["self_s"] += (b - a - child[i]) / 1e9
            end = last.get(i)
            if end is not None and end[2] == CLOSE_SYNC:
                row["close_syncs"] += 1
                row["close_sync_s"] += (end[1] - end[0]) / 1e9
    return main_segments


def _overlap(busy, a, b) -> int:
    """Nanoseconds of the sorted, disjoint intervals ``busy`` inside
    [a, b)."""
    i = max(bisect.bisect_right(busy, [a, float("inf")]) - 1, 0)
    total = 0
    while i < len(busy) and busy[i][0] < b:
        total += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return total


def _device_rows(segments, device, window, rows):
    """The card's busy and idle seconds by the innermost span open on the
    main thread at each instant of the panorama's range."""
    t0, t1 = window
    busy = trace._union([(max(a, t0), min(b, t1)) for a, b in device
                         if b > t0 and a < t1])
    spanned = spanned_busy = 0
    for a, b, n in segments:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            over = _overlap(busy, a, b)
            rows[n]["busy_s"] += over / 1e9
            rows[n]["idle_s"] += (b - a - over) / 1e9
            spanned += b - a
            spanned_busy += over
    rest_busy = sum(b - a for a, b in busy) - spanned_busy
    rows[UNSPANNED]["busy_s"] += rest_busy / 1e9
    rows[UNSPANNED]["idle_s"] += (t1 - t0 - spanned - rest_busy) / 1e9


def reduce(prof) -> dict[str, dict]:
    """Span name (without ``openpano:``) -> its row (module docstring),
    with the rows ``unspanned`` and ``other threads``; empty where the
    trace holds no span."""
    spans, items, device, window = _events(prof)
    if not spans:
        return {}
    rows = defaultdict(_row, {UNSPANNED: _row()})
    main = _main_thread(spans)
    segments = _host_rows(spans, items, main, rows)
    _device_rows(segments, device, window, rows)
    return dict(rows)


def table(rows: dict) -> str:
    """The rows as text, longest own host time first: name, count, self
    s, idle s, launches, syncs, sync-wait s, ops (own time each)."""
    head = (f"{'span':<26}{'count':>7}{'self s':>10}{'idle s':>10}"
            f"{'launches':>10}{'syncs':>7}{'sync s':>10}{'ops':>8}")
    lines = [head]
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["self_s"]):
        lines.append(f"{name:<26}{r['count']:>7}{r['self_s']:>10.4f}"
                     f"{r['idle_s']:>10.4f}{r['launches']:>10}"
                     f"{r['syncs']:>7}{r['sync_s']:>10.4f}{r['ops']:>8}")
    return "\n".join(lines)
