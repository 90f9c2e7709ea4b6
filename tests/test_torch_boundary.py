"""The port's boundary: no JAX, nothing of the JAX package, no silent CPU.

Every Python file of ``openpano_torch`` and ``chip_smoke.py`` is parsed and
any import of ``jax`` (or ``jaxlib``) or of ``openpano_tpu`` fails the test:
importing any module of the JAX package would start JAX and turn on x64 for
the whole process.  The entry point must refuse to run when there is no card
and no device was named.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "openpano_tpu")


def _port_files():
    files = sorted((ROOT / "openpano_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    files = _port_files()
    assert all(f.exists() for f in files)
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_raises_without_card(monkeypatch):
    """device=None means the card; without one the entry point raises
    instead of running on the CPU."""
    import numpy as np

    from openpano_torch import Config, stitch_images

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True)
    imgs = np.zeros((2, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stitch_images(imgs, cfg)


def test_kernel_wrappers_never_take_plain_path_on_card():
    """The wrappers route by the tensor's device: CPU tensors take the plain
    version, CUDA tensors launch the kernel; nothing else is accepted."""
    from openpano_torch.ops import windows

    meta = torch.empty(2, 3, 4, 5, device="meta")
    s = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        windows.orientation_histogram(meta[0], meta[0], s, s, s,
                                      s.float(), s.float(), 8,
                                      valid=s.bool())


@pytest.mark.parametrize("module", [
    "camera/rotation.py", "camera/camera.py", "camera/bundle_adjuster.py",
    "camera/banded.py", "camera/estimator.py", "io/image.py",
    "stitch/stitcher.py", "ops/windows.py", "stitch/warp.py",
    "stitch/cylstitcher.py", "stitch/multiband.py", "sift/brief.py",
    "cli.py", "io/artifacts.py", "utils/debug.py", "utils/draw.py",
    "bench/__init__.py", "bench/__main__.py", "bench/headline.py",
    "bench/roofline.py", "bench/kernel_check.py", "bench/giga.py",
    "bench/scaling.py", "bench/profile_sift.py", "bench/feature_batch.py",
    "bench/ba_sweep.py", "bench/comm_volume.py", "bench/run_test.py"])
def test_slice_modules_are_checked(module):
    """The camera stack, the image IO, the stitchers, the multiband blender,
    BRIEF, the CLI, the stage artifacts, the debug tools, the benches and
    the tools are among the files the import check above parses."""
    assert ROOT / "openpano_torch" / module in _port_files()


def _no_card_entries():
    """Entry points that must raise without a card: name -> call."""
    import numpy as np

    from openpano_torch import Config, cli
    from openpano_torch.bench import __main__ as bench_main
    from openpano_torch.bench import ba_sweep, comm_volume, feature_batch, \
        giga, kernel_check, profile_sift, roofline, run_test, scaling
    from openpano_torch.camera.estimator import estimate_cameras
    from openpano_torch.stitch.multiband import blend_multiband_host_stream
    from openpano_torch.stitch.render import blend_linear_host_stream, \
        plan_render
    from openpano_torch.stitch.stitcher import stitch, stitch_hetero

    n, M = 3, 4
    conf = np.zeros((n, n))
    conf[0, 1] = conf[1, 0] = conf[1, 2] = conf[2, 1] = 0.5
    u8 = np.zeros((2, 32, 32, 3), np.uint8)
    plan = plan_render(np.stack([np.eye(3)] * 2), np.full((2, 2), 32.0), 0,
                       "flat", 8000)
    return {
        "stitch_hetero": lambda: stitch_hetero([u8[0]] * 2, Config()),
        "estimate_cameras_on_card": lambda: estimate_cameras(
            conf, np.tile(np.eye(3), (n, n, 1, 1)), np.zeros((n, n, M, 2)),
            np.zeros((n, n, M, 2)), np.ones((n, n, M), bool),
            np.full((n, 2), 64.0), Config(BA_ON_HOST=False)),
        "cli_main": lambda: cli.main(["--mode", "planet", "missing.png"]),
        "host_stream_stitch": lambda: stitch(u8, Config()),
        "blend_linear_host_stream": lambda: blend_linear_host_stream(
            u8, plan, ordered=False, groups=2),
        "blend_multiband_host_stream": lambda: blend_multiband_host_stream(
            u8, plan, 2, groups=2),
        "bench": lambda: bench_main.main([]),
        "bench_kernel_check": lambda: kernel_check.check(),
        "bench_link": lambda: roofline.measure_link(),
        "giga_trans": lambda: giga.main(["--images", "2"]),
        "giga_rot": lambda: giga.main(["--mode", "rot", "--grid", "2", "1"]),
        "giga_trans2d": lambda: giga.main(["--mode", "trans2d", "--grid",
                                           "2", "1"]),
        "scaling": lambda: scaling.main(["--devices", "1"]),
        "profile_sift": lambda: profile_sift.main([]),
        "feature_batch": lambda: feature_batch.main(["1"]),
        "ba_sweep_r2": lambda: ba_sweep.main(["--small", "0"]),
        "ba_sweep_r5": lambda: ba_sweep.main(["--sweep", "r5", "fpat3"]),
        "comm_volume": lambda: comm_volume.main(["--devices", "1"]),
        "run_test": lambda: run_test.main(["--modes", "camera"]),
    }


@pytest.mark.parametrize("entry", ["stitch_hetero", "estimate_cameras_on_card",
                                   "cli_main", "host_stream_stitch",
                                   "blend_linear_host_stream",
                                   "blend_multiband_host_stream", "bench",
                                   "bench_kernel_check", "bench_link",
                                   "giga_trans", "giga_rot", "giga_trans2d",
                                   "scaling", "profile_sift", "feature_batch",
                                   "ba_sweep_r2", "ba_sweep_r5",
                                   "comm_volume", "run_test"])
def test_entry_points_raise_without_card(monkeypatch, entry):
    """stitch_hetero, the bundle adjustment on the card (BA_ON_HOST=False),
    the CLI without --device, the stitch whose host-stream trigger fires
    (OPENPANO_HOST_BLEND=1), the host-stream blends and the benches
    (``python -m openpano_torch.bench``, the kernel check, the link timing,
    each giga mode, the scaling bench) and the tools (the feature profile,
    the feature-batch sweep, both BA sweeps, the collective volume, the CLI
    harness) refuse to fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("OPENPANO_HOST_BLEND", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _no_card_entries()[entry]()
