"""The frozen work models against counts worked by hand."""

import math

import torch

from benchmark import workmodel


def _one_kp(R, radius, hw=1.0, active=True, y=10, x=10, H=32, W=32):
    t = lambda v, dt=torch.float32: torch.tensor([v], dtype=dt)
    return (1, H, W, t(0, torch.int32), t(y, torch.int32), t(x, torch.int32),
            t(radius), t(hw), t(1.0), t(0.0), t(float(H)), t(float(W)),
            torch.tensor([active]), R)


def test_k2_single_pixel_window():
    # radius 0: only the centre pixel is in the circle; at direction 0 and
    # bin width 1 it sits at (0, 0), inside the rotated grid [-2.5, 1.5]
    distinct, visits, n_active = workmodel.k2_window_need(*_one_kp(2, 0.0))
    assert (distinct, visits, n_active) == (1, 1, 1)
    nbytes, ops = workmodel.k2_work(*_one_kp(2, 0.0))
    assert nbytes == 1 * 8 + 1 + 1 * workmodel.K2_KP_BYTES + 128 * 4
    assert ops == 1 * workmodel.K2_OPS_PER_PIXEL


def test_k2_radius_one_cross():
    # radius 1, bin width 1: the 5 pixels of the plus sign are in the
    # circle, and all lie inside [-2.5, 1.5] in both rotated coordinates
    distinct, visits, _ = workmodel.k2_window_need(*_one_kp(2, 1.0))
    assert (distinct, visits) == (5, 5)


def test_k2_grid_cuts_the_window():
    # radius 3, bin width 1: the circle holds 29 pixels, but the rotated
    # grid keeps offsets in [-2, 1] on each axis: a 4 x 4 block, all of it
    # inside the circle of radius 3 (the farthest corner is (-2, -2))
    distinct, visits, _ = workmodel.k2_window_need(*_one_kp(3, 3.0))
    assert (distinct, visits) == (16, 16)


def test_k2_inactive_and_border():
    assert workmodel.k2_window_need(*_one_kp(2, 1.0, active=False)) \
        == (0, 0, 0)
    # at x = 1 the pixel x - 1 = 0 is outside the interior (>= 1)
    distinct, _, _ = workmodel.k2_window_need(*_one_kp(2, 1.0, x=1))
    assert distinct == 4


def test_k2_shared_pixels_counted_once():
    args = list(_one_kp(2, 1.0))
    for i in (3, 4, 5, 6, 7, 8, 9, 10, 11, 12):
        args[i] = torch.cat([args[i], args[i]])
    distinct, visits, n_active = workmodel.k2_window_need(*args)
    assert (distinct, visits, n_active) == (5, 10, 2)


def test_match_work_by_hand():
    counts = [100, 200, 50]
    nbytes, ops = workmodel.match_work(counts, [0, 1], [1, 2])
    assert ops == 2 * 100 * 200 * 128 + 2 * 200 * 50 * 128
    assert nbytes == (100 + 200 + 50) * 128 * 4
    nbytes, ops = workmodel.match_work(counts, [0], [2])
    assert nbytes == 150 * 128 * 4 and ops == 2 * 100 * 50 * 128


def test_least_seconds_takes_the_binding_roof():
    assert math.isclose(workmodel.least_seconds(3.35e12, 0), 1.0)
    assert math.isclose(workmodel.least_seconds(0, 67e12), 1.0)
    assert math.isclose(workmodel.least_seconds(3.35e12, 134e12), 2.0)
