"""Port parity: configuration, carried state, random draws and synthetic data.

The port keeps its own copies of the JAX package's Config and numpy-only
generators, and re-implements the threefry draws RANSAC consumes; each is
held here to the JAX package exactly (equal fields, equal bits, equal
pixels).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (turns on x64: RANSAC draws float64)
from openpano_tpu import config as jcfg
from openpano_tpu import synth as jsynth
from openpano_torch import compat, config as tcfg, synth as tsynth
from openpano_torch.utils import prng


def test_config_fields_and_defaults_equal():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jcfg.Config)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tcfg.Config)]
    assert tf == jf
    assert tcfg.Config.REFERENCE_KNOBS == jcfg.Config.REFERENCE_KNOBS
    assert tcfg.DEFAULT.DESC_LEN == jcfg.DEFAULT.DESC_LEN
    for sigma in (0.5, 1.4142135623, 2.0, 4.0, 7.9):
        for factor in (4, 6):
            assert tcfg.gauss_window_radius(sigma, factor) == \
                jcfg.gauss_window_radius(sigma, factor)


def test_config_validate_and_from_file(tmp_path):
    for kw in (dict(CYLINDER=True, ESTIMATE_CAMERA=True),
               dict(CYLINDER=True, ESTIMATE_CAMERA=False)):
        with pytest.raises(ValueError):
            tcfg.Config(**kw).validate()
        with pytest.raises(ValueError):
            jcfg.Config(**kw).validate()
    path = tmp_path / "c.cfg"
    lines = [f"{k} {int(getattr(jcfg.DEFAULT, k))}"
             if isinstance(getattr(jcfg.DEFAULT, k), bool)
             else f"{k} {getattr(jcfg.DEFAULT, k)}"
             for k in jcfg.Config.REFERENCE_KNOBS]
    lines[lines.index("TRANS 0")] = "TRANS 1  # translation mode"
    lines[lines.index("ESTIMATE_CAMERA 1")] = "ESTIMATE_CAMERA 0"
    path.write_text("\n".join(lines) + "\nNUM_OCTAVE 3\n")
    got = tcfg.Config.from_file(str(path))
    want = jcfg.Config.from_file(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.TRANS and got.NUM_OCTAVE == 3
    path.write_text("TRANS 1\n")
    with pytest.raises(KeyError):
        tcfg.Config.from_file(str(path))


def test_config_from_fields_roundtrip():
    j = jcfg.Config(TRANS=True, ESTIMATE_CAMERA=False, RANSAC_ITERATIONS=77)
    t = compat.config_from_fields(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(KeyError):
        compat.config_from_fields({"NOT_A_KNOB": 1})


@pytest.mark.parametrize("seed", [0, 1, 42, 2**33 + 5])
def test_threefry_split_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = compat.key_from_numpy(np.asarray(jk))
    for num in (1, 3, 38, 257):
        want = np.asarray(jax.random.split(jk, num)).astype(np.int64)
        got = prng.split(tk, num).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_threefry_uniform_bit_equal(seed):
    """float64 draws per pair slot, as RANSAC consumes them."""
    jk = jax.random.PRNGKey(seed)
    jkeys = jax.random.split(jk, 5)
    want = np.stack([np.asarray(jax.random.uniform(k, (400, 7)))
                     for k in jkeys])
    assert want.dtype == np.float64
    got = prng.uniform_f64(prng.split(compat.key_from_numpy(np.asarray(jk)),
                                      5), (400, 7)).numpy()
    np.testing.assert_array_equal(got, want)
    one = prng.uniform_f64(compat.key_from_numpy(np.asarray(jkeys[2])),
                           (3, 5)).numpy()
    np.testing.assert_array_equal(
        one, np.asarray(jax.random.uniform(jkeys[2], (3, 5))))


def test_synth_pixels_equal():
    np.testing.assert_array_equal(tsynth.procedural_scene(48, 64, 3),
                                  jsynth.procedural_scene(48, 64, 3))
    np.testing.assert_array_equal(tsynth.procedural_scene_large(96, 160, 4),
                                  jsynth.procedural_scene_large(96, 160, 4))
    scene = tsynth.procedural_scene(64, 256, 1)
    tv, tt = tsynth.render_views(scene, 3, out_w=40, out_h=30)
    jv, jt = jsynth.render_views(scene, 3, out_w=40, out_h=30)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(
        tsynth.gt_pair_homography(tt, 0, 2, 40, 30),
        jsynth.gt_pair_homography(jt, 0, 2, 40, 30))


def test_strip_views_translate():
    v = tsynth.strip_views(3, 64, 48, overlap=0.5, seed=2)
    assert v.shape == (3, 48, 64, 3) and v.dtype == np.float32
    assert 0.0 <= v.min() and v.max() <= 1.0
    # neighbours are translated crops of one texture: a 16-px patch at the
    # left edge of view k+1 reappears in view k, step (32) +- 16 px of
    # jitter to the right and +- 12 rows apart
    k0, k1 = v[0], v[1]
    patch = k1[12:36, :16]
    best = min(np.abs(k0[12 + dy:36 + dy, 32 + dx:48 + dx] - patch).max()
               for dx in range(-16, 17) for dy in range(-12, 13))
    assert best == 0.0


def test_key_default_is_prngkey0():
    np.testing.assert_array_equal(
        compat.key_from_numpy(np.asarray(jax.random.PRNGKey(0))).numpy(),
        prng.key((0, 0)).numpy())
    with pytest.raises(ValueError):
        compat.key_from_numpy(np.zeros(3, np.uint32))
