"""One traced run of a cell with the port's spans read from its trace.

    python3 -m benchmark.span_run --workload <name> --seed <n> \\
        --seconds <s> [--rows <path>]

from the root of a checkout.  It runs the cell as ``python3 -m
benchmark.run ... --trace 1`` does (``harness.run`` unchanged), and also
reduces the traced panorama's trace by its ``openpano:`` spans
(``spans.reduce``, taken where ``trace.reduce`` takes it): the span table
goes to standard error, and the metrics of ``spans.METRICS`` join the
result line's ``metrics`` where the trace has them.  The last line of
standard output is that JSON object; ``--rows`` writes every span row
(``spans.reduce``) as JSON to a file.  Exits with a non-zero code, and
prints no result, when there is no CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run as bench_run


def traced(cell, seed: int, seconds: float, device: str = "cuda",
           log=None) -> tuple[dict, dict]:
    """``harness.run(cell, seed, seconds, True)`` and the span rows of its
    traced panorama (empty where the trace holds no span); the rows are
    also the harness record's ``profile["spans"]``."""
    from benchmark import harness, spans, trace

    orig = trace.reduce
    got = {}

    def reduce(prof, kernel):
        out = orig(prof, kernel)
        got["rows"] = out["spans"] = spans.reduce(prof)
        return out

    trace.reduce = reduce
    try:
        result = harness.run(cell, seed, seconds, True, device=device,
                             log=log)
    finally:
        trace.reduce = orig
    rows = got.get("rows", {})
    for m in spans.entries([cell.name]):
        value = spans.metric(rows, m["name"])
        if value is not None:
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    return result, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rows", help="write the span rows here as JSON")
    args = ap.parse_args(argv)
    bench_run.environment()
    import torch

    from benchmark import spans, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    result, rows = traced(cell, args.seed, args.seconds)
    print(spans.table(rows), file=sys.stderr, flush=True)
    if args.rows:
        with open(args.rows, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
