"""The readings the comparison's limits are set from (``PERF.md``, "How
correct is decided"): for each seed, the numbers of the program's
panoramas, of the control (the reference, one precision step down, in the
program's place) and of the program with each planted fault
(``faults.py``), at the cell's own sizes.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 \\
        [--panos 2] [--faults lm_unchanged kp_scaled] [--no-control] \\
        [--via-run SECONDS] [--device cuda]

prints one JSON line a seed and fault.  With ``--via-run SECONDS`` it
makes whole runs of the harness instead, one a seed with a window of
that length, and prints each run's compared numbers: the program's own
lower-precision paths (``OPENPANO_MATCH_PRECISION=high`` or ``medium``
set for the command) are read so.  It is not part of a benchmark run:
the benchmark's runs compare the program's outputs only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, panos: int, faults, device: str,
             control: bool = True) -> list:
    import torch

    import openpano_torch
    from openpano_torch import Config
    from openpano_torch.ops import windows
    from openpano_torch.stitch import stitcher

    from benchmark import faults as fault_mod
    from benchmark import harness, judge

    cfg = Config(**cell.program())
    settings = harness.settings_of(cfg, cell)
    warm = cell.traffic.get("warmup", 1)
    pool = harness.make_pool(cell, seed, device, count=warm + panos)
    kw = {} if device != "cpu" else {"device": "cpu"}
    probes = harness.Probes(stitcher, windows)
    names = list(cell.limits)
    out = []
    try:
        for k in range(warm):
            openpano_torch.stitch_images(pool[k][0], cfg, output="u8", **kw)

        def one(views, truth, variants):
            info = {}
            probes.armed = True
            probes.reset()
            canvas, mask = openpano_torch.stitch_images(
                views, cfg, output="u8", info_out=info, **kw)
            probes.armed = False
            cap = harness._capture(views, truth, probes, info, canvas, mask)
            t0 = time.perf_counter()
            got = {v: judge.numbers(cap, settings, names, v, device)
                   for v in variants}
            got["program"]["judge_s"] = time.perf_counter() - t0
            return got

        def worst(rows, v):
            return {n: max(r[v][n] for r in rows) for n in rows[0][v]}

        variants = ("program", "control") if control else ("program",)
        rows = [one(*pool[warm + k], variants) for k in range(panos)]
        out.append({"seed": seed, **{v: worst(rows, v) for v in variants}})
        for name in faults:
            with fault_mod.FAULTS[name]():
                try:
                    rows = [one(*pool[warm + k], ("program",))
                            for k in range(panos)]
                    got = worst(rows, "program")
                except Exception as e:      # a fault may stop the stitch
                    got = {"raised": f"{type(e).__name__}: {e}"[:300]}
            out.append({"seed": seed, "fault": name, "program": got})
    finally:
        probes.close()
    del pool
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--panos", type=int, default=2)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--via-run", type=float, default=None)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import run, spec

    run.environment()

    cell = spec.load(args.workload)
    if args.via_run is not None:
        from benchmark import harness

        for seed in args.seeds:
            r = harness.run(cell, seed, args.via_run, False, args.device)
            print(json.dumps({
                "seed": seed, "correct": r["correct"],
                "env": {k: v for k, v in os.environ.items()
                        if k.startswith("OPENPANO_")},
                "program": {k: c["value"]
                            for k, c in r["compared"].items()}}), flush=True)
        return 0
    for seed in args.seeds:
        for row in readings(cell, seed, args.panos, args.faults,
                            args.device, not args.no_control):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
