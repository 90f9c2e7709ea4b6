"""Port parity for BRIEF against the JAX package, on the CPU: the pattern is
equal, the descriptors bit-equal as uint32 words (the port keeps them in
int64), the hamming matrices equal, and ``match_brief`` gives equal match
indices.  All integer or exact-compare arithmetic, so every gate is
equality."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.config import Config as JConfig
from openpano_tpu.sift import brief as jbrief
from openpano_torch.compat import config_from_fields
from openpano_torch.sift import brief as tbrief
from openpano_torch.synth import procedural_scene

JCFG = JConfig(MAX_MATCHES_PER_PAIR=64)
CFG = config_from_fields(dataclasses.asdict(JCFG))


def scene_pair():
    """Two 120x160 grey crops of one procedural scene, 12 px apart, with
    keypoints on the second that mark the same scene points (some half-way
    between pixels, some near or past the borders), and a few invalid."""
    rng = np.random.default_rng(0)
    grey = procedural_scene(140, 200, seed=3).mean(-1).astype(np.float32)
    a, b = grey[10:130, 20:180], grey[10:130, 8:168]
    K = 96
    pts = np.stack([rng.uniform(-2, 162, K), rng.uniform(-2, 122, K)],
                   -1).astype(np.float32)
    pts[:8] = np.round(pts[:8]) + 0.5          # ties: round half to even
    valid = rng.uniform(size=K) < 0.9
    return (a, pts, valid), (b, pts + np.float32([12.0, 0.0]), valid)


def descriptors(grey, pts, valid, pat):
    jd, jv = jbrief.compute_brief(jnp.asarray(grey), jnp.asarray(pts),
                                  jnp.asarray(valid), jnp.asarray(pat.offsets),
                                  pat.s)
    td, tv = tbrief.compute_brief(torch.from_numpy(grey), torch.from_numpy(pts),
                                  torch.from_numpy(valid), pat.offsets, pat.s)
    return (td, tv), (np.asarray(jd), np.asarray(jv))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pattern_equal(seed):
    t, j = tbrief.gen_brief_pattern(seed), jbrief.gen_brief_pattern(seed)
    assert t.s == j.s
    np.testing.assert_array_equal(t.offsets, j.offsets)


@pytest.mark.parametrize("view", [0, 1])
def test_descriptors_bit_equal(view):
    pat = jbrief.gen_brief_pattern(0)
    (td, tv), (jd, jv) = descriptors(*scene_pair()[view], pat)
    assert jd.dtype == np.uint32 and td.dtype == torch.int64
    np.testing.assert_array_equal(td.numpy().astype(np.uint32), jd)
    assert td.min() >= 0 and td.max() < 2**32
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert 0 < jv.sum() < len(jv)            # some dropped at the borders


def test_popcount_counts_bits():
    rng = np.random.default_rng(1)
    v = np.concatenate([[0, 1, 2**31, 2**32 - 1, 0x55555555, 0xAAAAAAAA],
                        rng.integers(0, 2**32, 1000)]).astype(np.uint64)
    want = np.array([bin(int(x)).count("1") for x in v])
    got = tbrief.popcount32(torch.from_numpy(v.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_hamming_matrix_equal():
    pat = jbrief.gen_brief_pattern(0)
    (a, b) = scene_pair()
    (ta, _), (ja, _) = descriptors(*a, pat)
    (tb, _), (jb, _) = descriptors(*b, pat)
    want = np.asarray(jbrief.hamming_dist_matrix(jnp.asarray(ja),
                                                  jnp.asarray(jb)))
    got = tbrief.hamming_dist_matrix(ta, tb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_brief_indices_equal():
    pat = jbrief.gen_brief_pattern(0)
    a, b = scene_pair()
    (ta, tva), (ja, jva) = descriptors(*a, pat)
    (tb, tvb), (jb, jvb) = descriptors(*b, pat)
    want = jbrief.match_brief(jnp.asarray(ja), jnp.asarray(jva),
                              jnp.asarray(jb), jnp.asarray(jvb), JCFG)
    got = tbrief.match_brief(ta, tva, tb, tvb, CFG)
    assert int(got.count[0]) == int(want.count)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.idx[0].numpy(), np.asarray(want.idx))
    # the same scene points: most matches pair a keypoint with itself
    m = got.idx[0][got.valid[0]].numpy()
    assert len(m) > 20 and (m[:, 0] == m[:, 1]).mean() > 0.9
