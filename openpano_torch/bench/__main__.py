"""``python -m openpano_torch.bench``: the headline bench, one JSON line.

    python -m openpano_torch.bench                  # the card
    python -m openpano_torch.bench --device cpu     # the plain versions
    BENCH_SMALL=1 python -m openpano_torch.bench    # 13 views of 640x480
"""

from __future__ import annotations

import argparse
import json

from .headline import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m openpano_torch.bench")
    ap.add_argument("--device", default=None,
                    help="run on this device (the card by default)")
    ap.add_argument("--report", action="store_true",
                    help="print the best run's stage timer report to stderr")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device, report=args.report)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
