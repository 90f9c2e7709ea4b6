"""The reduction of one profiled panorama's ``torch.profiler`` trace:
device busy time, kernel launches, the costliest device operations and
the device's idle time by the stage the host was in.  Plain torch."""

from __future__ import annotations

from collections import defaultdict

PANORAMA = "bench.panorama"   # the harness's range around the stitch
STAGE = "stage:"              # the harness's ranges around the stages


def _events(prof):
    """(name, start_ns, end_ns, on_device, is_range) of every event; a
    range the host opened (``record_function``) is also shown on the
    device's timeline, and is no device work: ``is_range`` marks the
    host's copy only."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        annotation = e.is_user_annotation()
        cuda = str(e.device_type()).endswith("CUDA")
        out.append((e.name(), start, start + e.duration_ns(),
                    cuda and not annotation,
                    not cuda and (e.name() == PANORAMA
                                  or e.name().startswith(STAGE))))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces of ATen and
    argument list, at most 96 characters."""
    name = name.removeprefix("void ").replace("at::native::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return (name or "(unnamed)")[:96]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(prof, kernel_of_interest: str) -> dict:
    """Busy and wall seconds of the panorama range, its kernel launches,
    the device seconds of kernels whose name contains
    ``kernel_of_interest``, the device's busy seconds inside each stage,
    the 10 costliest device operations by name and the 10 stages with the
    most device idle time."""
    evs = _events(prof)
    pano = [(a, b) for n, a, b, dev, rng in evs if rng and n == PANORAMA]
    if not pano:
        raise RuntimeError("the profiled panorama's range is not in the trace")
    t0, t1 = pano[0]
    dev = [(n, max(a, t0), min(b, t1)) for n, a, b, d, _ in evs
           if d and b > t0 and a < t1]
    busy = _union([(a, b) for _, a, b in dev])
    by_name = defaultdict(float)
    launches = 0
    k_s = 0.0
    for n, a, b in dev:
        by_name[short_name(n)] += (b - a) / 1e9
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            launches += 1
        if kernel_of_interest in n:
            k_s += (b - a) / 1e9
    stages = [(a, b, n[len(STAGE):]) for n, a, b, _, rng in evs
              if rng and n.startswith(STAGE)]
    idle = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [s for s in stages if s[0] <= mid < s[1]]
        label = max(inner)[2] if inner else "outside the stages"
        idle[label] += (b - a) / 1e9
    # the device's busy seconds inside each stage's ranges (the port's
    # stage scopes wait for the card before they close)
    stage_busy = defaultdict(float)
    for a, b, label in stages:
        stage_busy[label] += sum(max(0, min(b, y) - max(a, x))
                                 for x, y in busy) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"window_s": (t1 - t0) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "launches": launches, "kernel_s": k_s,
            "stage_busy_s": dict(stage_busy),
            "device_ops": top(by_name), "idle_gaps": top(idle)}
