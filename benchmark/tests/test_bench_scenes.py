"""The benchmark's own view generator: deterministic from (seed, index),
distinct across panoramas, and its truth maps one view onto the next."""

import numpy as np
import pytest
import torch

from benchmark import scenes

SWEEP = dict(n=4, width=240, height=180, hfov=40, overlap=0.5, jitter=0.05,
             shuffle=True, texture=[300, 2200])
STRIP = dict(n=4, width=200, height=160, overlap=0.6, jitter_x=8,
             jitter_y=6, texture=[240, 2048])
SEED = 2**31 + 77


@pytest.mark.parametrize("kind,params", [("sweep", SWEEP), ("strip", STRIP)])
def test_views_deterministic_and_distinct(kind, params):
    gen = scenes.generator(kind)
    a = gen.view_set(gen.build(params, SEED, "cpu"), params, SEED, 3)[0]
    b = gen.view_set(gen.build(params, SEED, "cpu"), params, SEED, 3)[0]
    state = gen.build(params, SEED, "cpu")
    c = gen.view_set(state, params, SEED, 4)[0]
    d = gen.view_set(gen.build(params, SEED + 1, "cpu"), params, SEED + 1,
                     3)[0]
    assert a.dtype == torch.uint8
    assert a.shape == (params["n"], params["height"], params["width"], 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, d)
    assert float(a.float().std()) > 30     # textured, not flat


def _pair_error(views, a, b, T, w, h):
    yy, xx = np.mgrid[12:h - 12:5, 12:w - 12:5]
    pb = np.stack([xx.ravel() - w / 2, yy.ravel() - h / 2,
                   np.ones(xx.size)], 1)
    pa = pb @ T.T
    xa = pa[:, 0] / pa[:, 2] + w / 2
    ya = pa[:, 1] / pa[:, 2] + h / 2
    ok = (xa >= 0) & (xa <= w - 2) & (ya >= 0) & (ya <= h - 2)
    x0, y0 = np.floor(xa[ok]).astype(int), np.floor(ya[ok]).astype(int)
    fx, fy = (xa[ok] - x0)[:, None], (ya[ok] - y0)[:, None]
    va = views[a].numpy().astype(float)
    got = (va[y0, x0] * (1 - fx) * (1 - fy) + va[y0, x0 + 1] * fx * (1 - fy)
           + va[y0 + 1, x0] * (1 - fx) * fy + va[y0 + 1, x0 + 1] * fx * fy)
    want = views[b].numpy().astype(float)[yy.ravel()[ok], xx.ravel()[ok]]
    return np.abs(got - want).mean()


@pytest.mark.parametrize("kind,params", [
    ("sweep", SWEEP), ("sweep", dict(SWEEP, pitch=3.0)), ("strip", STRIP)])
def test_truth_maps_adjacent_views(kind, params):
    gen = scenes.generator(kind)
    views, truth = gen.view_set(gen.build(params, SEED, "cpu"), params, SEED,
                                0)
    w, h = params["width"], params["height"]
    assert len(truth["adjacent"]) == params["n"] - 1
    for a, b, T in truth["adjacent"]:
        right = _pair_error(views, a, b, T, w, h)
        wrong = _pair_error(views, a, b, np.linalg.inv(T), w, h)
        assert right < 6 and wrong > 4 * right, (right, wrong)


def test_unknown_generator_raises():
    with pytest.raises(ValueError):
        scenes.generator("no_such_kind")
