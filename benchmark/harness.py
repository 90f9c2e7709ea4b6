"""One run of one cell: set-up, the measured window, the traced panorama,
the comparison that decides ``correct``, and the result line.

The loop is closed: one user stitches one view set after another through
``openpano_torch.stitch_images(views_u8, cfg, output="u8", info_out=...)``,
host uint8 views in, the u8 canvas and its mask back on the host.  Set-up
makes the scene and a pool of view sets on the device from the seed, keeps
the sets in host memory as a user's decoded photographs are, and stitches
one of them to warm up.  The window then stitches the pool's sets in
order, starting at the one after the warm-up's, for ``seconds``; it ends
with the last panorama completed.

The harness reads the port's own stage timers (``utils.timer``) and
transport counters (``io.wirecodec.STATS``) around each panorama.  It
wraps some of the port's functions for the whole run: the descriptor
stage of the detector and the all-pairs, the ring and the adjacent-pair
matcher, to copy to the host the keypoints and descriptors the features
gave and what the matcher got and returned, in the panoramas drawn for
the comparison; in CYLINDER mode also the cylinder stitcher's projector
and its RANSAC calls, to copy the pairs its chain multiplied (the
h-factor search's winning trial and the left half), which its
``info_out`` does not hold.  With ``trace``, one panorama after the
middle of the window runs under ``torch.profiler``, with ranges around
the stitch and its stages (the port's ``total_timer`` scopes, of the
general and the cylinder stitcher) and a recorder on K2's launcher; the
per-layer metrics read the other, clean panoramas and that one.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import judge, scenes, sift_ref, spec, trace, workmodel

FORBIDDEN = ("jax", "jaxlib", "flax", "openpano_tpu")
K2_KERNEL = "desc_hist_kernel"


def process_seconds() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """What a run read, for the per-layer metrics' readers."""
    cell: spec.Cell
    settings: dict
    panos: list = field(default_factory=list)    # clean panoramas
    profile: dict | None = None                  # the traced panorama

    def stage_per_pano(self, label: str) -> float | None:
        """Seconds a clean panorama spent in the port's stage timer
        ``label`` (which waits for the card at its scope's end); None where
        a panorama did not run the stage."""
        times = [p["stages"].get(label) for p in self.panos]
        if not times or None in times:
            return None
        return sum(times) / len(times)


def settings_of(cfg, cell: spec.Cell) -> dict:
    """The configuration values the comparison needs, as plain data."""
    keys = ("MATCH_REJECT_NEXT_RATIO", "MAX_MATCHES_PER_PAIR",
            "ORDERED_INPUT", "TRANS", "ESTIMATE_CAMERA", "CYLINDER",
            "FOCAL_LENGTH", "MAX_OUTPUT_SIZE", "MULTIBAND") + sift_ref.KEYS
    return {**{k: getattr(cfg, k) for k in keys},
            "precision": cell.config["precision"],
            "reference": cell.config.get("reference", "reference")}


def make_pool(cell: spec.Cell, seed: int, device,
              count: int | None = None) -> list:
    """The run's view sets: [(u8 host views, truth)], made on ``device``;
    the first ``count`` of them when given."""
    t = cell.traffic
    gen = scenes.generator(t["kind"])
    state = gen.build(t["params"], seed, device)
    pool = []
    for k in range(t["pool"] if count is None else count):
        views, truth = gen.view_set(state, t["params"], seed, k)
        pool.append((views.cpu().numpy(), truth))
    del state
    return pool


def draw_sample(seed: int, n: int = 2, first: int = 4) -> set:
    """The window panoramas whose outputs are compared: ``n`` of the first
    ``first``, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (2**64), 7])
    return set(rng.choice(first, size=n, replace=False).tolist())


class Probes:
    """The wrappers the harness puts around the port's functions, undone
    by ``close``."""

    def __init__(self, stitcher, windows, traced: bool = False):
        self._saved = []
        self.armed = False
        self.captured = None
        self.kps = []
        self.chain = []          # CYLINDER: (h-factor, ii, jj, MatchInfo)
        self._factor = None
        self.k2_calls = None     # list while the traced panorama runs
        self.ranges = False
        from openpano_torch.sift import detector
        from openpano_torch.stitch import cylstitcher

        self._wrap(detector, "describe_keypoints", self._describe)
        for name in ("match_all_pairs", "match_ring_pairs"):
            self._wrap(stitcher, name, self._matcher)
        self._wrap(cylstitcher, "match_adjacent_pairs", self._matcher)
        self._wrap(cylstitcher, "make_projector", self._projector)
        self._wrap(cylstitcher, "estimate_transform_batch", self._chain)
        if traced:
            self._wrap(windows, "desc_hist_cuda", self._k2)
            for mod in (stitcher, cylstitcher):
                self._wrap(mod, "total_timer", self._timer)

    def reset(self):
        """Forget what the last panorama left."""
        self.captured, self.kps, self.chain = None, [], []

    def _wrap(self, mod, name, make):
        orig = getattr(mod, name)
        self._saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def close(self):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)

    def _matcher(self, orig):
        def probe(desc, valid, cfg):
            res = orig(desc, valid, cfg)
            if self.armed:
                self.captured = dict(desc=desc.cpu(), valid=valid.cpu(),
                                     idx=res.idx.cpu(), count=res.count.cpu())
            return res
        return probe

    def _projector(self, orig):
        def probe(w, h, h_factor, cfg):
            self._factor = h_factor
            return orig(w, h, h_factor, cfg)
        return probe

    def _chain(self, orig):
        def probe(matches, pos, valid, whs, ii, jj, key, cfg, affine,
                  keys=None):
            info = orig(matches, pos, valid, whs, ii, jj, key, cfg, affine,
                        keys=keys)
            if self.armed:
                self.chain.append((self._factor, np.asarray(ii),
                                   np.asarray(jj),
                                   [f.cpu() for f in info]))
            return info
        return probe

    def _describe(self, orig):
        def probe(kp, mag, ort, cfg, wh=None):
            desc = orig(kp, mag, ort, cfg, wh=wh)
            if self.armed:
                fields = dict(kp._asdict(), w=wh[..., 0], h=wh[..., 1])
                for b in range(desc.shape[0]):
                    v = kp.valid[b]
                    self.kps.append({k: fields[k][b][v].cpu()
                                     for k in sift_ref.KP_FIELDS})
            return desc
        return probe

    def _k2(self, orig):
        def probe(mag, ort, s, y, x, radius, hw, co, si, dirv, hb, wb,
                  active, R):
            if self.k2_calls is None:
                return orig(mag, ort, s, y, x, radius, hw, co, si, dirv, hb,
                            wb, active, R)
            with torch.profiler.record_function("k2"):
                out = orig(mag, ort, s, y, x, radius, hw, co, si, dirv, hb,
                           wb, active, R)
            # the planes' shape, not the planes: they are freed as usual
            self.k2_calls.append((tuple(mag.shape), s, y, x, radius, hw, co,
                                  si, hb, wb, active, int(R)))
            return out
        return probe

    def _timer(self, orig):
        @contextlib.contextmanager
        def scope(label):
            if not self.ranges:
                with orig(label):
                    yield
                return
            with torch.profiler.record_function(trace.STAGE + label), \
                    orig(label):
                yield
        return scope


def _stage_totals(timer) -> dict:
    return {k: v[1] for k, v in timer.totals().items()}


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", log=None) -> dict:
    """One run of ``cell``; returns the result line's object."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    import openpano_torch
    from openpano_torch import Config
    from openpano_torch.io import wirecodec
    from openpano_torch.ops import windows
    from openpano_torch.stitch import stitcher
    from openpano_torch.utils import timer

    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = Config(**cell.program())
    settings = settings_of(cfg, cell)
    t_imported = process_seconds()
    pool = make_pool(cell, seed, device)
    t_pool = process_seconds()
    sample = draw_sample(seed)
    probes = Probes(stitcher, windows, traced)
    kw = {} if on_card else {"device": "cpu"}

    def stitch(views, info):
        return openpano_torch.stitch_images(views, cfg, output="u8",
                                            info_out=info, **kw)

    rec = Run(cell, settings)
    captures, attempted, failed = [], 0, 0
    try:
        for k in range(cell.traffic.get("warmup", 1)):
            stitch(pool[k % len(pool)][0], {})
        sync()
        setup_s = process_seconds()
        log(f"set-up {setup_s:.3f} s: imports {t_imported:.3f}, pool "
            f"{t_pool - t_imported:.3f}, warm-up {setup_s - t_pool:.3f}; "
            f"sample {sorted(sample)}")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        wirecodec.reset_stats()
        walls, t_end = [], None
        t0 = time.perf_counter()
        k = 0
        profiled_at = None
        while True:
            views, truth = pool[(cell.traffic.get("warmup", 1) + k)
                                % len(pool)]
            profile_now = (traced and profiled_at is None and k not in sample
                           and time.perf_counter() - t0 >= seconds / 2)
            probes.armed = k in sample
            probes.reset()
            info = {}
            st0 = _stage_totals(timer)
            up0 = wirecodec.STATS["up_bytes"]
            attempted += 1
            prof = None
            ts = time.perf_counter()
            try:
                if profile_now:
                    probes.k2_calls, probes.ranges = [], True
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if on_card:
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    with torch.profiler.profile(activities=acts) as prof:
                        with torch.profiler.record_function(trace.PANORAMA):
                            canvas, mask = stitch(views, info)
                            sync()
                else:
                    canvas, mask = stitch(views, info)
                    sync()
                ok = True
            except Exception:
                failed += 1
                ok = False
                log(f"panorama {k} failed:\n{traceback.format_exc()}")
            finally:
                probes.ranges = False
            te = time.perf_counter()
            t_end = te
            st1 = _stage_totals(timer)
            if ok:
                if prof is None:
                    walls.append(te - ts)
                pano = dict(
                    index=k, wall_s=te - ts,
                    stages={lb: st1[lb] - st0.get(lb, 0.0) for lb in st1},
                    up_bytes=wirecodec.STATS["up_bytes"] - up0,
                    kpt_counts=np.asarray(info.get("kpt_counts", [])),
                    n=views.shape[0], lm_iters=info.get("lm_iters"),
                    lm_time_s=info.get("lm_time_s"))
                if prof is not None:
                    profiled_at = k
                    rec.profile = dict(pano, prof=prof,
                                       k2_calls=probes.k2_calls)
                elif k in sample:
                    captures.append(_capture(views, truth, probes,
                                             info, canvas, mask))
                else:
                    rec.panos.append(pano)
            probes.k2_calls = None
            k += 1
            # the window ends with the panorama that crosses ``seconds``, and
            # not before the compared panoramas have run and, traced, the
            # profiled one and a clean one
            if te - t0 >= seconds and k > max(sample) and (
                    failed or not traced
                    or (profiled_at is not None and rec.panos)):
                break
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        probes.close()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark and the "
                         "port must not import JAX or the JAX package")
    completed = len(walls)
    result = {"correct": False, "attempted": attempted, "failed": failed}
    metrics = {}
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": (torch.cuda.get_device_name() if on_card
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
    if on_card:
        device_rec["power_limit"] = power_limit()
    if completed:
        log(f"{completed} panoramas in {t_end - t0:.3f} s; per panorama "
            f"p50 {np.percentile(walls, 50):.4f} s, p90 "
            f"{np.percentile(walls, 90):.4f} s")
    if not traced:
        e2e = {"pano_s": (t_end - t0) / max(completed, 1),
               "peak_device_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    elif rec.profile is not None:
        prof = rec.profile.pop("prof")
        rec.profile.update(trace.reduce(prof, K2_KERNEL))
        del prof
        rec.profile["k2_least_s"] = sum(
            workmodel.least_seconds(*workmodel.k2_work(*c[0], *c[1:]))
            for c in rec.profile.pop("k2_calls") or [])
        device_rec["busy_s"] = rec.profile["busy_s"]
        device_rec["window_s"] = rec.profile["window_s"]
        result["breakdown"] = {"device_ops": rec.profile["device_ops"],
                               "idle_gaps": rec.profile["idle_gaps"]}
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the comparison runs once the window's state is freed and its peak read
    del pool
    if on_card:
        torch.cuda.empty_cache()
    worst = {}
    for cap in captures:
        got = judge.numbers(cap, settings, cell.limits, device=device)
        for name, v in got.items():
            worst[name] = max(worst.get(name, v), v)
    correct = (failed == 0 and bool(captures)
               and set(worst) == set(cell.limits)
               and judge.verdict(worst, cell.limits))
    compared = {name: {"value": worst.get(name), "limit": lim}
                for name, lim in cell.limits.items()}
    for name, c in compared.items():
        log(f"compared {name}: {c['value']} (limit {c['limit']})")
    log(f"compared panoramas: {len(captures)}; failed: {failed}")
    result.update(correct=correct, metrics=metrics, device=device_rec)
    result["compared"] = compared
    return result


def _capture(views, truth, probes: Probes, info: dict, canvas,
             mask) -> judge.Capture:
    probe = probes.captured
    if probe is None or len(probes.kps) != len(views):
        raise RuntimeError("the probes saw no matcher call or not every "
                           "view's features in a compared panorama")
    if "graph" in info:
        g = info["graph"]
        graph = dict(conf=g.conf, homo=g.homo, to_pos=g.to_pos,
                     from_pos=g.from_pos, valid=g.valid)
    else:
        graph = _chain_graph(len(views), probes.chain, info["hfactor"])
    return judge.Capture(
        views=views, truth=truth, desc=probe["desc"], valid=probe["valid"],
        match_idx=probe["idx"], match_count=probe["count"], graph=graph,
        homos=np.asarray(info["homos"], np.float64), canvas=canvas, mask=mask,
        kps=probes.kps, hfactor=info.get("hfactor"))


def _chain_graph(n: int, chain: list, hfactor: float) -> dict:
    """The pairs a CYLINDER stitch chained, as the general stitcher's
    graph lays them out: each RANSAC result at [to, from], in warped
    half-shifted coordinates.  ``chain`` holds the stitch's RANSAC calls
    in order: the h-factor search's trials (pairs (k, k + 1) right of the
    middle view), of which the one run at the chosen h-factor made the
    chain, then the left half (pairs (i + 1, i))."""
    right = [c for c in chain if c[0] == hfactor and (c[2] > c[1]).all()]
    left = [c for c in chain if (c[2] < c[1]).all()]
    if not right and not left:
        raise RuntimeError("the probes saw no RANSAC call of the chain")
    M = (right or left)[-1][3][2].shape[1]
    graph = dict(conf=np.zeros((n, n), np.float32),
                 homo=np.tile(np.eye(3, dtype=np.float32), (n, n, 1, 1)),
                 to_pos=np.zeros((n, n, M, 2), np.float32),
                 from_pos=np.zeros((n, n, M, 2), np.float32),
                 valid=np.zeros((n, n, M), bool))
    for _, ii, jj, fields in right[-1:] + left[-1:]:
        for name, v in zip(("homo", "conf", "to_pos", "from_pos", "valid"),
                           fields):
            graph[name][ii, jj] = v.numpy()
    return graph
