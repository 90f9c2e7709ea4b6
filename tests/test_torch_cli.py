"""The port's command line on the CPU (``--device cpu``).

Every mode runs and writes its artifact (reference: main.cc debug
subcommands, main.cc:333-357), the stitch mode prints the JAX CLI's
``metrics:`` keys, the matchinfo dump reloads to the same canvas, and the
numpy debug pieces (the planet remap, ``PlaneDrawer``) draw the JAX
package's pixels.  No JAX stitch runs here: the JAX CLI's metric keys are
read from its source, and only its planet mode (numpy) runs.
"""

import ast
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openpano_torch import cli
from openpano_torch.config import Config
from openpano_torch.io.image import read_img_u8, write_rgb
from openpano_torch.synth import procedural_scene_large, render_views

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module: its Python loops issue many
    small ops, and the test workers share the CPU, so more threads would
    only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def img_files(tmp_path_factory):
    """Two PNG views of 480x360 of a rotating camera, 60% overlap."""
    d = tmp_path_factory.mktemp("cli_imgs")
    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 2,
                            out_w=480, out_h=360, hfov_deg=30, overlap=0.6,
                            seed=3)
    paths = []
    for i, v in enumerate(views):
        p = str(d / f"{i}.png")
        write_rgb(p, v)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def tiny_cfg_file(tmp_path_factory):
    """tests/test_cli.py's config: every reference knob (a missing key is
    fatal, lib/config.cc:31-35) at its default, with small caps."""
    p = str(tmp_path_factory.mktemp("cli_cfg") / "config.cfg")
    values = {k: getattr(Config, k) for k in Config.REFERENCE_KNOBS}
    values.update(
        SIFT_WORKING_SIZE=200, NUM_OCTAVE=2, NUM_SCALE=7,
        PRE_COLOR_THRES=2e-2, CONTRAST_THRES=2e-2,
        MAX_CAND_PER_OCTAVE=256, MAX_KP_PER_OCTAVE=128,
        MAX_DESC_PER_OCTAVE=128, MAX_KP_PER_IMAGE=256,
        MAX_MATCHES_PER_PAIR=128, RANSAC_ITERATIONS=64,
    )
    with open(p, "w") as f:
        for k, v in values.items():
            f.write(f"{k} {int(v) if isinstance(v, bool) else v}\n")
    return p


def run(*argv) -> int:
    return cli.main(["--device", "cpu", *argv])


@pytest.mark.parametrize(
    "mode,nimg,artifact",
    [
        ("stitch", 2, "out.png"),
        ("keypoint", 1, "log/keypoint.jpg"),
        ("raw_extrema", 1, "log/extrema.jpg"),
        ("orientation", 1, "log/orientation.jpg"),
        ("match", 2, "log/match.jpg"),
        ("inlier", 2, "log/inlier.jpg"),
        ("warp", 1, "log/warped.jpg"),
        ("planet", 1, "log/planet.jpg"),
    ],
)
def test_mode_writes_artifact(img_files, tiny_cfg_file, tmp_path, monkeypatch,
                              capsys, mode, nimg, artifact):
    monkeypatch.chdir(tmp_path)
    assert run("--mode", mode, "-c", tiny_cfg_file, "-o", "out.png",
               *img_files[:nimg]) == 0
    assert os.path.getsize(artifact) > 0
    out = capsys.readouterr().out
    assert f"Wrote {artifact}" in out
    assert "peak rss: " in out.splitlines()[-1]


def jax_metric_keys() -> list[str]:
    """The keys of the ``metrics`` dict in the JAX CLI's source."""
    tree = ast.parse((ROOT / "openpano_tpu" / "cli.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "metrics"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no metrics dict in openpano_tpu/cli.py")


def test_stitch_metrics_line(img_files, tiny_cfg_file, tmp_path, monkeypatch,
                             capsys):
    monkeypatch.chdir(tmp_path)
    assert run("-c", tiny_cfg_file, "-o", "a.png", "--seed", "3",
               *img_files) == 0
    lines = capsys.readouterr().out.splitlines()
    got = [ln for ln in lines if ln.startswith("metrics: ")]
    assert len(got) == 1
    metrics = json.loads(got[0][len("metrics: "):])
    assert list(metrics) == jax_metric_keys()
    assert len(metrics["kpt_counts"]) == 2 and min(metrics["kpt_counts"]) > 0
    assert metrics["connected_pairs"] == 1
    canvas = read_img_u8("a.png")
    assert canvas.shape[0] > 0 and canvas.shape[1] > 480
    # the per-label timer report (process totals) and the peak RSS
    assert any(re.fullmatch(r"calc_feature: \d+ calls, [\d.]+ s total", ln)
               for ln in lines)
    assert re.fullmatch(r"peak rss: \d+ MiB", lines[-1])


def test_matchinfo_roundtrip_and_debug_blend(img_files, tiny_cfg_file,
                                             tmp_path, monkeypatch):
    """The reference's fixture workflow (debug.cc:19-43, 111-140): stitch
    with --dump-matchinfo, stitch again with --load-matchinfo (feature and
    match skipped), and the per-image blender renders.  PNG out, so the two
    canvases compare pixel for pixel."""
    monkeypatch.chdir(tmp_path)
    mi = str(tmp_path / "matchinfo.txt")
    assert run("-c", tiny_cfg_file, "-o", "a.png", "--dump-matchinfo", mi,
               "--debug-blend", *img_files) == 0
    assert os.path.getsize(mi) > 0
    assert os.path.exists("log/blended-00.jpg")
    assert os.path.exists("log/blended-01.jpg")
    from openpano_torch.ops import windows

    before = windows.orientation_histogram.launches
    assert run("-c", tiny_cfg_file, "-o", "b.png", "--load-matchinfo", mi,
               *img_files) == 0
    assert windows.orientation_histogram.launches == before
    np.testing.assert_array_equal(read_img_u8("a.png"), read_img_u8("b.png"))


def test_planet_matches_jax_cli(img_files, tiny_cfg_file, tmp_path,
                                monkeypatch):
    """The toy polar remap (main.cc:294-331) of both CLIs writes the same
    JPEG."""
    from openpano_tpu import cli as jcli

    monkeypatch.chdir(tmp_path)
    assert jcli.main(["--mode", "planet", "-c", tiny_cfg_file,
                      img_files[0]]) == 0
    want = Path("log/planet.jpg").read_bytes()
    os.remove("log/planet.jpg")
    assert run("--mode", "planet", "-c", tiny_cfg_file, img_files[0]) == 0
    assert Path("log/planet.jpg").read_bytes() == want


def test_plane_drawer_matches_jax():
    """The same calls from the same ``default_rng`` seed draw the same
    pixels."""
    from openpano_tpu.utils.draw import PlaneDrawer as JDrawer
    from openpano_torch.utils.draw import PlaneDrawer

    base = np.random.default_rng(1).uniform(size=(90, 120, 3)).astype(
        np.float32)
    out = []
    for cls in (PlaneDrawer, JDrawer):
        d = cls(base.copy())
        rng = np.random.default_rng(5)
        for k in range(6):
            d.set_rand_color(rng)
            d.cross(10 + 17 * k, 20 + 9 * k, 3)
            d.point(5 * k, 80 - k, 1)
            d.line(-5, 7 * k, 130, 90 - 11 * k)
            d.circle(60, 45, 4 + 5 * k)
            d.arrow(60, 45, 0.7 * k, 12)
        d.polygon([(3, 3), (110, 10), (90, 80), (20, 70)])
        out.append(d.img)
    np.testing.assert_array_equal(out[0], out[1])
    assert (out[0] != base).any()


def test_main_raises_without_card(img_files, tiny_cfg_file, tmp_path,
                                  monkeypatch):
    """No --device means the card; without one the CLI raises instead of
    running on the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", tiny_cfg_file, *img_files])
    assert not os.path.exists("out.jpg")
