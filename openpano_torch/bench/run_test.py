"""The CLI integration harness, the counterpart of ``tools/run_test.py``
(itself the reference's src/run_test.py:20-49).

    python -m openpano_torch.bench.run_test [--device cpu] [--jobs-dir DIR]
        [--modes cylinder camera]

For each mode it writes 6 PNG views of 320x240 (32 degree field of view,
50% overlap) of ``procedural_scene_large(1400, 11000)`` (the JAX tool
renders its photo scene) and a config file with every reference knob (a
missing one is fatal, lib/config.cc:31-35) set for the mode, with the JAX
tool's caps; runs ``python -m openpano_torch.cli`` on them in a
subprocess (with ``--device`` when one is given); parses ``Final Image
Size: (w, h)`` from its output; and holds each dimension within a ratio of
0.8 of the golden size: (1080, 250) in CYLINDER mode, (1010, 280) with
ESTIMATE_CAMERA.  One JSON line per mode with the size, the golden, the
subprocess's wall and the device record; a mode that fails raises after
its line.  The JAX tool's cross-check against the reference binary drives
``tools/ref_parity.py`` and the C++ build, not the package, and is not
ported.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from ..config import Config
from ..stitch.stitcher import resolve_device
from . import device_record

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = {"cylinder": (1080, 250), "camera": (1010, 280)}
RATIO = 0.8
MODES = {
    "cylinder": dict(CYLINDER=1, ESTIMATE_CAMERA=0, TRANS=0, ORDERED_INPUT=1),
    "camera": dict(CYLINDER=0, ESTIMATE_CAMERA=1, TRANS=0, ORDERED_INPUT=0),
}
CAPS = dict(SIFT_WORKING_SIZE=400, RANSAC_ITERATIONS=400,
            MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=512,
            MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
            MAX_DESC_PER_OCTAVE=512)


def dataset_views(n: int = 6):
    """n f32 views of 320x240 of the procedural scene."""
    from ..synth import procedural_scene_large, render_views

    return render_views(procedural_scene_large(1400, 11000, seed=0), n,
                        out_w=320, out_h=240, hfov_deg=32, overlap=0.5)[0]


def generate_dataset(d: str, views) -> list[str]:
    """The views as PNG files in ``d``; their paths."""
    from ..io.image import write_rgb

    paths = []
    for k, v in enumerate(views):
        paths.append(os.path.join(d, f"view{k:02d}.png"))
        write_rgb(paths[-1], v)
    return paths


def write_config(d: str, mode: str) -> str:
    """config.cfg in ``d``: every reference knob at its default, the mode's
    and the caps' values over them."""
    values = {k: getattr(Config, k) for k in Config.REFERENCE_KNOBS}
    values.update(MODES[mode])
    values.update(CAPS)
    path = os.path.join(d, "config.cfg")
    with open(path, "w") as f:
        for k, v in values.items():
            f.write(f"{k} {int(v) if isinstance(v, bool) else v}\n")
    return path


def run_one(d: str, mode: str, views, device=None) -> dict:
    """The CLI on ``views`` written to ``d``, in ``mode``; its JSON dict
    (``ok`` False, with the reason, when the size is off or the run
    failed)."""
    imgs = generate_dataset(d, views)
    write_config(d, mode)
    cmd = [sys.executable, "-m", "openpano_torch.cli", *imgs,
           "-o", os.path.join(d, "out.png")]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=d, capture_output=True, text=True,
                         timeout=1800, env=env)
    wall = time.perf_counter() - t0
    line = {"mode": mode, "golden": list(GOLDEN[mode]), "wall_s": wall,
            "returncode": out.returncode}
    m = re.search(r"Final Image Size: \((\d+), (\d+)\)", out.stdout)
    if out.returncode != 0 or not m:
        return dict(line, ok=False, size=None,
                    reason=(out.stderr or out.stdout)[-2000:])
    w, h = int(m.group(1)), int(m.group(2))
    gw, gh = GOLDEN[mode]
    ratio = lambda a, b: min(a, b) / max(a, b)
    ok = ratio(w, gw) > RATIO and ratio(h, gh) > RATIO
    return dict(line, ok=ok, size=[w, h],
                reason=None if ok else "size deviates from golden")


def run(device=None, modes=tuple(MODES), jobs_dir: str | None = None) -> list:
    """One dict per mode (module docstring)."""
    dev = resolve_device(device)
    record = device_record(dev)
    arg = None if device is None else dev.type
    views = dataset_views()
    lines = []
    with tempfile.TemporaryDirectory(prefix="openpano_it_") as tmp:
        base = jobs_dir or tmp
        for mode in modes:
            d = os.path.join(base, mode)
            os.makedirs(d, exist_ok=True)
            lines.append(dict(run_one(d, mode, views, arg), **record))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m openpano_torch.bench.run_test")
    ap.add_argument("--jobs-dir", default=None)
    ap.add_argument("--modes", nargs="+", choices=tuple(MODES),
                    default=list(MODES))
    ap.add_argument("--device", default=None,
                    help="run on this device (the card by default)")
    args = ap.parse_args(argv)
    lines = run(device=args.device, modes=args.modes, jobs_dir=args.jobs_dir)
    for line in lines:
        print(json.dumps(line), flush=True)
    bad = [line["mode"] for line in lines if not line["ok"]]
    if bad:
        raise SystemExit(f"run_test: {bad} failed")
    print("Test passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
