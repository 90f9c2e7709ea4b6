"""The CUDA kernels on the card against their plain versions (the window
kernels within a gate, the extrema kernels bit for bit, the RANSAC kernel
against a float64 refit of its own inliers and the CPU's plain chain), and
the card's paths against the CPU or their in-memory forms (the pair-major LM, a
CYLINDER + multiband stitch, BRIEF, the host-stream blends, the CLI).

Needs an NVIDIA card and ``nvcc``; skips elsewhere (the kernels have no CPU
mode: a CPU tensor takes the plain version).  Imports nothing of JAX, so it
also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -m cuda

Gate: max|a-b| / max|b| < 1e-4 against the plain version on the same card
tensors (f32 summation order only), and two launches give the same bits.
"""

import json
import os

import numpy as np
import pytest
import torch

from openpano_torch.ops import windows
from openpano_torch.sift import extrema
from openpano_torch.sift.pyramid import Octave

import extrema_cases as ec

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, dev, S=5, H=60, W=90, K=64, R=8, B=None):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(
        mag=t(rng.uniform(0, 1, lead + (S, H, W)).astype(np.float32)),
        ort=t(rng.uniform(0, 2 * np.pi, lead + (S, H, W)).astype(np.float32)),
        s=t(rng.integers(0, S, lead + (K,)).astype(np.int32)),
        y=t(rng.integers(0, H, lead + (K,)).astype(np.int32)),
        x=t(rng.integers(0, W, lead + (K,)).astype(np.int32)),
        rad=t(rng.integers(1, R + 1, lead + (K,)).astype(np.float32)),
        invden=t(rng.uniform(0.005, 0.1, lead + (K,)).astype(np.float32)),
        hw=t(rng.uniform(1.5, 5.0, lead + (K,)).astype(np.float32)),
        dirv=t(rng.uniform(0, 2 * np.pi, lead + (K,)).astype(np.float32)),
        wh=t(np.stack([rng.integers(W // 2, W + 1, lead + (K,)),
                       rng.integers(H // 2, H + 1, lead + (K,))], -1
                      ).astype(np.float32)),
        valid=t(rng.uniform(size=lead + (K,)) < 0.8),
    )


def _run(which, c, R):
    if which == "ori":
        return windows.orientation_histogram(
            c["mag"], c["ort"], c["s"], c["y"], c["x"], c["rad"], c["invden"],
            R, wh=c["wh"], valid=c["valid"])
    return windows.descriptor_histogram(
        c["mag"], c["ort"], c["s"], c["y"], c["x"], c["rad"], c["hw"],
        c["dirv"], R, wh=c["wh"], valid=c["valid"])


@pytest.mark.parametrize("which,R,B", [("ori", 8, None), ("ori", 8, 3),
                                       ("desc", 19, None), ("desc", 16, 3)])
def test_kernel_matches_plain_on_card(card, which, R, B):
    c = _case(11, card, R=R, B=B)
    wrapper = (windows.orientation_histogram if which == "ori"
               else windows.descriptor_histogram)
    before = wrapper.launches
    a, b = _run(which, c, R), _run(which, c, R)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2      # one launch per call, batch folded
    want = _run(which, {k: v.cpu() for k, v in c.items()}, R)
    assert torch.equal(a, b)
    got = a.cpu().double()
    err = (got - want.double()).abs().max() / want.abs().max().clamp(min=1e-6)
    assert float(err) < TOL
    assert (got[~c["valid"].cpu()] == 0).all()


def _edge_case(which, dev, S=2, H=96, W=128, K=64):
    """Pixels exactly on bin edges.  Descriptor: direction 0 and bin widths
    2 and 4 put ybin, xbin = offset / width + 1.5 on -1 and 3 exactly, and
    orientations on the multiples of 2*pi/8, at 2*pi (hbin 8, wrapping to
    bin 0) and one ulp under it.  Orientation: its 36 bin edges, 0, 2*pi
    and one ulp under 2*pi."""
    R = 8 if which == "ori" else 19
    two_pi = np.float32(2 * np.pi)
    under = np.nextafter(two_pi, np.float32(0))
    if which == "ori":
        vals = np.r_[(np.arange(36, dtype=np.float32) + np.float32(0.5))
                     * (two_pi / np.float32(36)), 0, two_pi, under]
    else:
        vals = np.r_[np.arange(9, dtype=np.float32) * (two_pi / np.float32(8)),
                     under]
    vals = vals.astype(np.float32)
    rng = np.random.default_rng(21)
    i = np.arange(K)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return R, dict(
        mag=t(rng.uniform(0.5, 1.5, (S, H, W)).astype(np.float32)),
        ort=t(vals[np.arange(S * H * W) % len(vals)].reshape(S, H, W)),
        s=t((i % S).astype(np.int32)),
        y=t((R + 2 + (i * 7) % (H - 2 * R - 4)).astype(np.int32)),
        x=t((R + 2 + (i * 13) % (W - 2 * R - 4)).astype(np.int32)),
        rad=t(np.where(i % 3 == 0, R, i % R + 1).astype(np.float32)),
        invden=t(np.full(K, 0.02, np.float32)),
        hw=t(np.where(i % 2 == 0, 2.0, 4.0).astype(np.float32)),
        dirv=t(np.zeros(K, np.float32)),
        wh=t(np.tile(np.float32([W, H]), (K, 1))),
        valid=t(i % 9 != 4),
    )


@pytest.mark.parametrize("which", ["ori", "desc"])
def test_kernel_matches_plain_on_bin_edges(card, which):
    """The crafted edge case on the card against the plain version on the
    CPU: the same gate, and two launches give the same bits."""
    R, c = _edge_case(which, card)
    a, b = _run(which, c, R), _run(which, c, R)
    torch.cuda.synchronize()
    want = _run(which, {k: v.cpu() for k, v in c.items()}, R)
    assert torch.equal(a, b)
    err = (a.cpu().double() - want.double()).abs().max() / want.abs().max()
    assert float(err) < TOL
    assert (a.cpu()[~c["valid"].cpu()] == 0).all()


@pytest.mark.parametrize("S,H,W,WR,B", [(3, 100, 300, 32, None),
                                        (4, 61, 397, 56, None),
                                        (3, 50, 140, 24, 2)])
def test_slab_kernel_equals_plain_on_card(card, S, H, W, WR, B):
    """K3 against its plain version on the same card tensors: a copy, so
    bit-equal, keypoints past every border and planes out of range too."""
    rng = np.random.default_rng(S * H)
    lead = () if B is None else (B,)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    a = t(rng.uniform(size=lead + (S, H, W)).astype(np.float32))
    b = t(rng.uniform(size=lead + (S, H, W)).astype(np.float32))
    s_hi = S if B is not None else S + 2
    s = t(rng.integers(0 if B is not None else -2, s_hi,
                       lead + (64,)).astype(np.int32))
    y = t(rng.integers(-8, H + 8, lead + (64,)).astype(np.int32))
    x = t(rng.integers(-8, W + 8, lead + (64,)).astype(np.int32))
    before = windows.gather_window_slabs.launches
    got = windows.gather_window_slabs(a, b, s, y, x, WR)
    again = windows.gather_window_slabs(a, b, s, y, x, WR)
    torch.cuda.synchronize()
    assert windows.gather_window_slabs.launches == before + 2
    fold = (lambda v: v) if B is None else (lambda v: v.reshape(-1, *v.shape[2:]))
    offs = 0 if B is None else (torch.arange(B, device=card)[:, None] * S)
    want = windows.win2_plain(fold(a), fold(b), (s + offs).reshape(-1),
                              y.reshape(-1), x.reshape(-1), WR)
    for g, r, w in zip(got, again, want):
        assert torch.equal(g, r)
        assert torch.equal(g.reshape(w.shape), w)


def _extrema_both(dog, cap_cand, cap_kp, cfg=ec.CFG):
    """The kernels (twice) and the plain version on one card DoG stack:
    every field equal in dtype, shape and bits, at most three launches a
    call.  Returns the kernels' keypoints."""
    o = Octave(None, None, None, dog)
    before = extrema.detect_extrema.launches
    got = extrema.detect_extrema(o, cfg, cap_cand, cap_kp)
    again = extrema.detect_extrema(o, cfg, cap_cand, cap_kp)
    torch.cuda.synchronize()
    assert 0 < extrema.detect_extrema.launches - before <= 6
    want = extrema.detect_extrema_plain(o, cfg, cap_cand, cap_kp)
    for f in extrema.RawKeypoints._fields:
        g, r, w = getattr(got, f), getattr(again, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert torch.equal(g, r) and torch.equal(g, w), f
    return got


@pytest.mark.parametrize("cap_cand,cap_kp", [(4096, 128), (40, 128),
                                             (4096, 16)])
def test_extrema_kernels_equal_plain_on_crafted_volumes(card, cap_cand,
                                                         cap_kp):
    """``tests/extrema_cases.py``'s plants (more than 32 candidates in a
    block, more than cap_cand, a step out of the interior, a singular
    Hessian, offsets of exactly +-0.5, 1.5 and 2.5, the edge-ratio limit)
    and an empty image whose slots are all padding."""
    got = _extrema_both(ec.octave(ec.crafted(), card).dog, cap_cand, cap_kp)
    assert got.valid[0].any() and not got.valid[1].any()


@pytest.mark.parametrize("B,h,w,smooth,caps", [
    (3, 67, 100, 0, (512, 128)), (2, 133, 200, 1, (1024, 512)),
    (1, 41, 300, 2, (4096, 2048)), (4, 3, 3, 0, (128, 128))])
def test_extrema_kernels_equal_plain_on_noise(card, B, h, w, smooth, caps):
    """Seeded noise: candidates past every cap, steps, failures and
    survivors at random, and the smallest octave the kernels take."""
    dog = ec.octave(ec.noise(B, h, w, seed=h * w, smooth=smooth), card).dog
    _extrema_both(dog, *caps)


@pytest.fixture(scope="module")
def cell_octaves():
    """The DoG stacks and caps each octave of the main path hands the
    extrema, for the first views of panorama 0 of the benchmark's two
    cells (1300x867 and 1500x1112 views, 959x640 and 918x681 at working
    size), in feature batches of 4 and of 1, with the working size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from benchmark import scenes
    from openpano_torch.config import Config
    from openpano_torch.ops.imgproc import working_size
    from openpano_torch.sift import detector
    from openpano_torch.stitch.stitcherbase import compute_features

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "camera_linear.json")) as f:
        cfg = Config(**json.load(f)["program"])
    real = detector.detect_extrema
    out = {}
    for traffic in ("cmu0_unordered38", "ordered13"):
        with open(os.path.join(root, "benchmark", "traffic",
                               f"{traffic}.json")) as f:
            spec = json.load(f)
        gen, p = scenes.generator(spec["kind"]), spec["params"]
        seed = 2**31 + 17
        views, _ = gen.view_set(gen.build(p, seed, "cuda"), p, seed, 0)
        for B in (4, 1):
            seen = []

            def rec(octave, cfg, cap_cand=None, cap_kp=None):
                seen.append((octave.dog, cap_cand, cap_kp))
                return real(octave, cfg, cap_cand, cap_kp)

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(detector, "detect_extrema", rec)
                mp.setenv("OPENPANO_FEATURE_BATCH", str(B))
                compute_features(views[:B], cfg)
            work = working_size(p["width"], p["height"],
                                cfg.SIFT_WORKING_SIZE)
            out[traffic, B] = (cfg, work, seen)
    return out


@pytest.mark.parametrize("traffic", ["cmu0_unordered38", "ordered13"])
@pytest.mark.parametrize("B", [4, 1])
def test_extrema_kernels_equal_plain_at_the_cells_shapes(cell_octaves,
                                                          traffic, B):
    """Every octave of a feature batch of the cells' views, at their caps
    (4096 / 2048 candidates halving per octave), bit for bit."""
    cfg, (h, w), seen = cell_octaves[traffic, B]
    assert len(seen) == cfg.NUM_OCTAVE
    assert seen[0][0].shape == (B, cfg.NUM_SCALE - 1, h, w)
    assert [c for _, c, _ in seen] == [4096, 2048, 1024, 512]
    for dog, cap_cand, cap_kp in seen:
        assert _extrema_both(dog, cap_cand, cap_kp, cfg).valid.any()


@pytest.fixture(scope="module")
def sweep_ransac():
    """What the main path hands ``estimate_transform_batch`` for panorama 0
    of the benchmark's cmu0 traffic (38 views of 1300x867 of a 336 degree
    sweep, ``benchmark/generators/sweep.py``): its kept pairs, about 700 of
    703, with their keypoints and keys, and the cell's configuration."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from benchmark import scenes
    from openpano_torch.config import Config
    from openpano_torch.stitch import stitcher
    from openpano_torch.stitch.stitcherbase import compute_features
    from openpano_torch.utils import prng

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "camera_linear.json")) as f:
        program = json.load(f)["program"]
    with open(os.path.join(bench, "traffic", "cmu0_unordered38.json")) as f:
        spec = json.load(f)
    cfg = Config(**program, **spec["program"])
    gen, p = scenes.generator(spec["kind"]), spec["params"]
    seed = 2**31 + 23
    views, _ = gen.view_set(gen.build(p, seed, "cuda"), p, seed, 0)
    feats = compute_features(views, cfg)
    whs = torch.tensor([[p["width"], p["height"]]] * p["n"],
                       dtype=torch.float32, device="cuda")
    real, seen = stitcher.estimate_transform_batch, []

    def rec(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stitcher, "estimate_transform_batch", rec)
        stitcher.build_pairwise_graph(feats, whs, cfg, prng.key((0, 7), "cuda"),
                                      ordered=False, affine=False)
    (args, kw), = seen
    return cfg, args[:6], kw["keys"]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a NaN equals a NaN of the same bits)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[P] whether row p of a and of b are equal bit for bit."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return (a == b).reshape(a.shape[0], -1).all(dim=1)


def _inlier_counts(info) -> torch.Tensor:
    """The best hypothesis's inlier count of each pair: ``count`` where it
    connects, ``-confidence`` where it fails."""
    return torch.where(info.count > 0, info.count.double(),
                       -info.confidence.double()).round().long().cpu()


def _gaps(Ha, Hb, pts, w) -> np.ndarray:
    """Each pair's largest distance between the images of its rows ``pts``
    [P, M, 2] where ``w`` is set, under Ha and under Hb, in float64."""
    from benchmark.reference import apply_h

    Ha, Hb, pts = (np.asarray(torch.as_tensor(a).cpu(), np.float64)
                   for a in (Ha, Hb, pts))
    d = np.linalg.norm(apply_h(Ha, pts) - apply_h(Hb, pts), axis=-1)
    return np.where(w.cpu().numpy(), d, 0.0).max(axis=1, initial=0.0)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("M", [1024, 64])
def test_ransac_kernel_against_refit_and_plain(sweep_ransac, affine, M):
    """The RANSAC kernel on the kept pairs of a cmu0 panorama, perspective
    and affine, at the cell's 1024 match rows and cut to 64 (the counts
    are not clipped, so many pass the buffer), with every 16th pair
    emptied (count 0, no valid row: the mesh path's padding).  Gated on
    what no summation order moves: one launch a call and the same bits
    from every entry point; empty pairs fail; each connected pair's
    transform within the cmu0 cell's ``refit_px`` limit of a float64
    refit of its own inliers; against the plain chain on the CPU, whose
    sums round in other orders (so a match on the threshold's edge may
    fall the other way and move a pair's best hypothesis; Threefry bit
    errors would move them all), the same winner on 99% of the pairs: its
    inlier count (the kernel's recount of its winner, the chain's score of
    its own), success and the inlier lists equal, and the transforms of
    those that connect within 0.25 px over the inliers.
    The pairs equal bit for bit to the plain chain on the card, whose
    orders the kernel copies, are reported."""
    from openpano_torch.geometry import ransac
    from openpano_torch.match.matcher import MatchResult

    cfg, (res, pos, valid, whs, ii, jj), keys = sweep_ransac
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "limits",
                           "camera_linear.cmu0_unordered38.json")) as f:
        refit_limit = json.load(f)["refit_px"]
    P = len(ii)
    empty = torch.arange(P, device="cuda") % 16 == 5
    res = MatchResult(res.idx[:, :M].contiguous(),
                      res.valid[:, :M] & ~empty[:, None],
                      torch.where(empty, 0, res.count))
    assert P > 600 and ((res.count > M).sum() > 50) == (M == 64)
    side = (pos, valid, whs)
    ij = torch.tensor([ii, jj], dtype=torch.int64, device="cuda")
    before = ransac.estimate_transform.launches
    got = [ransac.estimate_transform_cuda(res, side, side, ij, keys, cfg,
                                          affine) for _ in range(2)]
    batch = ransac.estimate_transform_batch(res, pos, valid, whs, ii, jj,
                                            None, cfg, affine, keys=keys)
    assert ransac.estimate_transform.launches - before == 3
    for f in ransac.MatchInfo._fields:
        assert _same_bits(getattr(got[0], f), getattr(got[1], f)), f
        assert _same_bits(getattr(got[0], f), getattr(batch, f)), f
    # the CLI's single-pair call: row p of both images
    for p in (0, P // 2, P - 1):
        one = ransac.estimate_transform(
            MatchResult(*(f[p : p + 1] for f in res)), pos[ii[p]][None],
            valid[ii[p]][None], pos[jj[p]][None], valid[jj[p]][None],
            whs[ii[p]][None], whs[jj[p]][None], keys[p : p + 1], cfg, affine)
        for f in ransac.MatchInfo._fields:
            assert _same_bits(getattr(one, f)[0], getattr(got[0], f)[p]), f
    got = got[0]
    ok = (got.count > 0).cpu()
    assert (got.count[empty] == 0).all() and (got.confidence[empty] <= 0).all()
    assert not got.valid[empty].any() and int(ok.sum()) > 30

    from benchmark.reference import refit
    want = refit(got.to_pos.cpu().numpy(), got.from_pos.cpu().numpy(),
                 got.valid.cpu().numpy(), affine)
    refit_px = float(_gaps(got.homo, want, got.from_pos, got.valid).max())

    cpu = ransac.estimate_transform_batch_plain(
        MatchResult(*(f.cpu() for f in res)), pos.cpu(), valid.cpu(),
        whs.cpu(), ii, jj, keys.cpu(), cfg, affine)
    agree = ((_inlier_counts(got) == _inlier_counts(cpu))
             & (ok == (cpu.count > 0)))
    for f in ("to_pos", "from_pos", "valid"):
        agree &= _rows_equal(getattr(got, f).cpu(), getattr(cpu, f))
    both = agree & ok
    gap = _gaps(got.homo.cpu()[both], cpu.homo[both], got.from_pos.cpu()[both],
                got.valid.cpu()[both])
    card = ransac.estimate_transform_batch_plain(res, pos, valid, whs, ii,
                                                 jj, keys, cfg, affine)
    equal = sum(all(_same_bits(getattr(got, f)[p], getattr(card, f)[p])
                    for f in ransac.MatchInfo._fields) for p in range(P))
    print(f"\nRANSAC kernel (affine={affine}, M={M}): {P} pairs, "
          f"{int(ok.sum())} connect; refit_px {refit_px:.4g} (limit "
          f"{refit_limit}); against the CPU's plain chain: inlier count and "
          f"success and inliers equal on {int(agree.sum())}, largest gap "
          f"{gap.max(initial=0.0):.4g} px; bit-equal to the card's plain "
          f"chain on {equal} (torch {torch.__version__})")
    assert refit_px < refit_limit
    assert float(agree.float().mean()) >= 0.99, int((~agree).sum())
    assert gap.max(initial=0.0) < 0.25


@pytest.mark.parametrize("banded", [False, True])
def test_lm_on_card_matches_host_c_routine(card, banded):
    """The pair-major LM on card tensors (the torch chain) against the same
    problem on CPU tensors (the C routine, ``camera/ba_pairs.py``): the same
    iterations, parameters within the card-against-host tolerance of
    ``chip_smoke.py`` (rel 1e-6), and no call into C from the card."""
    from openpano_torch.camera import ba_pairs
    from openpano_torch.camera import bundle_adjuster as tba

    from test_torch_ba_pairs import _problem

    params, prob, n = _problem(7, n=5)
    if banded:
        keep = ((prob.cam_from - prob.cam_to) == 1) | (
            (prob.cam_to == 0) & (prob.cam_from == n - 1))
        prob = tba.BAPairProblem(*(t[keep] for t in prob))
    kw = dict(adaptive=True, max_iter=40, banded=banded)
    p = torch.from_numpy(params)
    host, it_host = tba.ba_optimize_pairs(p, prob, n // 2, n, 5.0, **kw)
    before = ba_pairs.calls
    on_card = tba.BAPairProblem(*(t.to(card) for t in prob))
    got, it_card = tba.ba_optimize_pairs(p.to(card), on_card, n // 2, n, 5.0,
                                         **kw)
    assert ba_pairs.calls == before
    assert it_card == it_host > 3
    got = got.cpu().numpy()
    want = host.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_cylinder_multiband_stitch_card_equals_cpu(card):
    """A small CYLINDER + MULTIBAND=2 stitch (6 views of 320x240, u8) on the
    card and on the CPU: the same h-factor and canvas size, valid masks
    agreeing on >= 99.9% of pixels, NCC >= 0.999."""
    from openpano_torch import Config, stitch_images
    from openpano_torch.synth import procedural_scene_large, render_views

    views, _ = render_views(procedural_scene_large(600, 2400, seed=2), 6,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    u8 = np.round(views * 255).astype(np.uint8)
    cfg = Config(CYLINDER=True, ESTIMATE_CAMERA=False, ORDERED_INPUT=True,
                 MULTIBAND=2, RANSAC_ITERATIONS=400, MAX_CAND_PER_OCTAVE=1024,
                 MAX_KP_PER_OCTAVE=512, MAX_DESC_PER_OCTAVE=512,
                 MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=512,
                 SIFT_WORKING_SIZE=400)
    res = []
    for dev in (card, "cpu"):
        info = {}
        canvas, valid = stitch_images(u8, cfg, output="u8", device=dev,
                                      info_out=info)
        res.append((canvas.astype(np.float64), valid, info))
    (gc, gv, gi), (cc, cv, ci) = res
    assert gi["hfactor"] == ci["hfactor"]
    assert gc.shape == cc.shape
    assert (gv == cv).mean() >= 0.999 and cv.mean() > 0.8
    m = gv & cv
    a, b = gc[m] - gc[m].mean(), cc[m] - cc[m].mean()
    assert (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()) >= 0.999


def test_brief_card_equals_cpu(card):
    """BRIEF descriptors and matches on the card equal the CPU's bit for
    bit: comparisons, bit packing and integer popcounts only."""
    from openpano_torch import Config
    from openpano_torch.sift import brief
    from openpano_torch.synth import procedural_scene

    rng = np.random.default_rng(0)
    grey = procedural_scene(300, 400, seed=3).mean(-1).astype(np.float32)
    pat = brief.gen_brief_pattern(0)
    K = 2048
    pts = np.stack([rng.uniform(-2, 362, K), rng.uniform(-2, 242, K)],
                   -1).astype(np.float32)
    valid = rng.uniform(size=K) < 0.9
    cfg = Config(MAX_MATCHES_PER_PAIR=1024)
    out = []
    for dev in (card, "cpu"):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        da, va = brief.compute_brief(t(grey[:280, :380]), t(pts), t(valid),
                                     pat.offsets, pat.s)
        db, vb = brief.compute_brief(t(grey[10:290, 12:392]),
                                     t(pts - np.float32([12, 10])), t(valid),
                                     pat.offsets, pat.s)
        m = brief.match_brief(da, va, db, vb, cfg)
        out.append([v.cpu() for v in (da, va, db, vb, *m)])
    for g, c in zip(*out):
        assert torch.equal(g, c)
    assert int(out[1][-1][0]) > 100


def _flat_plan_views(n=6):
    """6 u8 views of 320x240 on a flat plan of 90 px translations (the data
    of tests/test_torch_host_blend.py)."""
    from openpano_torch.stitch.render import plan_render
    from openpano_torch.synth import procedural_scene_large, render_views

    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), n,
                            out_w=320, out_h=240, hfov_deg=30, overlap=0.55,
                            seed=7)
    homos = np.stack([np.eye(3) for _ in range(n)])
    homos[:, 0, 2] = 90.0 * (np.arange(n) - n // 2)
    plan = plan_render(homos, np.repeat([[320.0, 240.0]], n, 0), n // 2,
                       "flat", 8000)
    return np.round(views * 255).astype(np.uint8), plan


@pytest.mark.parametrize("multiband", [0, 2])
def test_host_stream_blend_equals_in_memory_on_card(card, multiband):
    """The host-stream blends on the card (the default device) against the
    card's in-memory blends of the uploaded stack: valid masks agree on
    >= 99.9% of pixels, values within 1e-5 (linear) / 1e-4 (multiband)."""
    from openpano_torch.stitch.multiband import blend_multiband_host_stream
    from openpano_torch.stitch.render import blend, blend_linear_host_stream

    u8, plan = _flat_plan_views()
    if multiband:
        got = blend_multiband_host_stream(u8, plan, multiband, groups=3)
    else:
        got = blend_linear_host_stream(u8, plan, ordered=True, groups=3)
    src = torch.from_numpy(u8).to(card).to(torch.float32) / 255.0
    want = blend(src, plan, ordered=True, multiband=multiband).cpu().numpy()
    vg, vw = got[..., 0] >= 0, want[..., 0] >= 0
    assert got.shape == want.shape and (vg == vw).mean() >= 0.999
    both = vg & vw
    assert both.mean() > 0.5
    assert np.abs(got[both] - want[both]).max() <= (1e-4 if multiband
                                                    else 1e-5)


def test_cli_stitches_on_card(card, tmp_path, monkeypatch):
    """``cli.main`` with no --device on two PNG views of 480x360: exit 0,
    a PNG canvas wider than one view, K1 and K2 launched."""
    from openpano_torch import Config, cli
    from openpano_torch.io.image import read_img_u8, write_rgb
    from openpano_torch.synth import procedural_scene_large, render_views

    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 2,
                            out_w=480, out_h=360, hfov_deg=30, overlap=0.6,
                            seed=3)
    files = []
    for i, v in enumerate(views):
        files.append(str(tmp_path / f"{i}.png"))
        write_rgb(files[-1], v)
    values = {k: getattr(Config, k) for k in Config.REFERENCE_KNOBS}
    values.update(SIFT_WORKING_SIZE=400, MAX_KP_PER_IMAGE=1024,
                  MAX_MATCHES_PER_PAIR=512)
    cfg = tmp_path / "config.cfg"
    cfg.write_text("".join(f"{k} {int(v) if isinstance(v, bool) else v}\n"
                           for k, v in values.items()))
    monkeypatch.chdir(tmp_path)
    k1, k2 = (windows.orientation_histogram.launches,
              windows.descriptor_histogram.launches)
    assert cli.main(["-c", str(cfg), "-o", "out.png", *files]) == 0
    assert windows.orientation_histogram.launches > k1
    assert windows.descriptor_histogram.launches > k2
    canvas = read_img_u8("out.png")
    assert canvas.shape[1] > 480 and canvas.shape[0] > 100


# ---- the transport on the card ----

def _planes(seed=0):
    """u8 planes for the codec: smooth rows with a little noise (inline
    exceptions), one with more (past the inline prefix), pure noise (the
    raw branch), and one with deltas in [-1, 1] (the 2-bit codec)."""
    rng = np.random.default_rng(seed)

    def smooth(rows, cols, step=3, frac=0.0):
        x = np.cumsum(rng.integers(-step, step + 1, (rows, cols)), 1)
        p = ((x + rng.integers(0, 256, (rows, 1))) % 256).astype(np.uint8)
        m = rng.uniform(size=p.shape) < frac
        p[m] = rng.integers(0, 256, int(m.sum()))
        return p

    return {"inline": (smooth(600, 1300, frac=0.005), 4),
            "past inline": (smooth(400, 400, frac=0.03), 4),
            "raw": (rng.integers(0, 256, (300, 700)).astype(np.uint8), 4),
            "2-bit": (smooth(500, 900, step=1), 2)}


def test_coded_fetch_on_card_equals_the_plane(card, monkeypatch):
    """CodedFetch of card planes (every branch, and row chunks) equals a
    plain .cpu() of them; the card's encode equals the CPU's bit for bit."""
    from openpano_torch.io import wirecodec as twc

    for name, (p, bits) in _planes().items():
        dev = torch.from_numpy(p).to(card)
        got = twc.CodedFetch(dev, bits=bits).wait()
        np.testing.assert_array_equal(got, dev.cpu().numpy(), err_msg=name)
        cap = p.size // 12
        for a, b in zip(twc.encode_plane_device(dev, cap, bits, 8192),
                        twc.encode_plane_device(dev.cpu(), cap, bits, 8192)):
            assert torch.equal(a.cpu(), b), name
    monkeypatch.setattr(twc, "_MAX_PLANE", 1 << 16)
    p = _planes(1)["inline"][0]
    fetch = twc.CodedFetch(torch.from_numpy(p).to(card))
    assert len(fetch._parts) > 1
    np.testing.assert_array_equal(fetch.wait(), p)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.bool_])
def test_fetch_on_card_equals_cpu(card, dtype):
    """fetch (one pinned asynchronous copy) and the row-delta pair on card
    tensors equal a plain .cpu() of them, bit for bit."""
    from openpano_torch.io import transfer

    rng = np.random.default_rng(15)
    x = rng.integers(0, 256, (3, 700, 900))
    x = (rng.normal(size=x.shape) if dtype == np.float32 else
         x & 1 if dtype == np.bool_ else x).astype(dtype)
    dev = torch.from_numpy(x).to(card)
    got = transfer.fetch(dev)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(transfer.fetch(dev[:, ::2]), x[:, ::2])
    if dtype == np.uint8:
        np.testing.assert_array_equal(transfer.fetch_u8_delta(dev), x)
        up = transfer.device_put_u8_delta(x, card)
        assert up.device.type == "cuda"
        np.testing.assert_array_equal(up.cpu().numpy(), x)


@pytest.mark.parametrize("bits", [4, 2])
def test_background_upload_on_card(card, bits):
    """A gated BackgroundUpload on its own stream, released, in 64 KB
    chunks: the decoded card tensor equals the plane; an abandoned one
    raises; upload_u8_rows and upload_2bit_rows land on the card."""
    from openpano_torch.io import wirecodec as twc

    planes = _planes(2)
    p = planes["2-bit" if bits == 2 else "inline"][0]
    bg = twc.BackgroundUpload(lambda: p, gate_wire=True, bits=bits,
                              device=card)
    bg.CHUNK_BYTES = 1 << 16
    bg.release_wire()
    got = bg.result()
    assert got.device.type == "cuda"
    # work queued on the default stream after result() sees the data
    np.testing.assert_array_equal((got.to(torch.int32) + 0).cpu().numpy(), p)
    raw = planes["raw"][0]
    np.testing.assert_array_equal(
        twc.BackgroundUpload(raw, device=card).result().cpu().numpy(), raw)
    gone = twc.BackgroundUpload(p, gate_wire=True, device=card)
    gone.abandon()
    with pytest.raises(RuntimeError, match="abandoned"):
        gone.result()
    up = twc.upload_u8_rows(p, card)
    assert up.device.type == "cuda"
    np.testing.assert_array_equal(up.cpu().numpy(), p)
    r = (p % 3).astype(np.uint8)
    np.testing.assert_array_equal(twc.upload_2bit_rows(r, card).cpu().numpy(),
                                  r)


def _sweep(n=12, H=240, W=320, seed=0):
    from openpano_torch.stitch.render import plan_render

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8)
    Kinv = np.linalg.inv(np.diag([float(W), float(W), 1.0]))
    homos = []
    for i in range(n):
        th = (i - n / 2) * 2.4 / n
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        homos.append(R.T @ Kinv)
    plan = plan_render(np.stack(homos), np.repeat([[float(W), float(H)]], n,
                                                  0), n // 2, "spherical",
                       8000)
    return imgs, plan


@pytest.mark.parametrize("groups,coded", [(4, "1"), (4, "0"), (3, "1")])
def test_stream_blend_on_card_equals_in_memory(card, monkeypatch, groups,
                                               coded):
    """blend_linear_stream_u8 on the card equals the card's blend_linear
    followed by f32_to_u8 bit for bit, coded download on and off, at the
    in-memory blend's 4 strips and at 3."""
    from openpano_torch.stitch import render

    monkeypatch.setenv("OPENPANO_CODED_DOWNLOAD", coded)
    u8, plan = _sweep()
    src = torch.from_numpy(u8).to(card).to(torch.float32) / 255.0
    got = render.blend_linear_stream_u8(src, plan, ordered=False,
                                        groups=groups)
    rgb, valid = render.f32_to_u8(render.blend_linear(src, plan, False))
    want = np.concatenate([rgb.cpu().numpy(), valid.cpu().numpy()[..., None]
                           .astype(np.uint8)], -1)
    assert got.shape == want.shape and valid.cpu().numpy().mean() > 0.5
    np.testing.assert_array_equal(got, want)


def test_transport_features_and_stack_on_card(card):
    """upload_and_compute_features on the card: the features equal
    compute_features of the uploaded stack bit for bit, K1 and K2 launch,
    and the deferred stack equals the u8 stack / 255 bit for bit."""
    from openpano_torch import Config
    from openpano_torch.stitch import stitcherbase as sb
    from openpano_torch.synth import procedural_scene_large, render_views

    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    u8 = np.round(views * 255).astype(np.uint8)
    cfg = Config(MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
                 MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024)
    k1 = windows.orientation_histogram.launches
    imgs, got = sb.upload_and_compute_features(u8, cfg, device=card)
    assert windows.orientation_histogram.launches == k1 + 2   # 2 batches
    want = sb.compute_features(torch.from_numpy(u8).to(card), cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    imgs.start_background()
    stack = imgs.get()
    assert torch.equal(stack, torch.from_numpy(u8).to(card).float() / 255.0)


def test_kernel_check_on_card(card):
    """openpano_torch.bench.kernel_check on the JAX tool's case: K1, K2 and
    the resize within 1e-4 of their plain versions, each kernel launched
    once; the extrema kernels at the headline's shapes bit-equal to their
    plain version, launched twice an octave."""
    from openpano_torch.bench import kernel_check

    got = kernel_check.check(device=card)
    assert got["ok"], got
    assert got["extrema_equal"]
    assert got["launches"] == {"orientation_histogram": 1,
                               "descriptor_histogram": 1,
                               "detect_extrema": 8}


def test_link_rates_positive(card):
    from openpano_torch.bench import roofline

    rates = roofline.measure_link(card)
    assert rates["h2d_bytes_per_s"] > 0 and rates["d2h_bytes_per_s"] > 0


def test_bench_small_passes_gates(card, monkeypatch):
    """The headline bench at BENCH_SMALL=1 (13 views of 640x480): bench.py's
    gates hold (run raises otherwise), the kernel check passes and every
    timed run launches K1 and K2 once per feature batch."""
    from openpano_torch.bench import headline

    monkeypatch.setenv("BENCH_SMALL", "1")
    out = headline.run()
    extra = out["extra"]
    assert extra["images"] == 13 and extra["kernel_parity"]["ok"]
    assert extra["mean_reproj_err_px"] < headline.REPROJ_LIMIT_PX
    assert extra["multiband"]["ncc_vs_linear"] > headline.MB_NCC_LIMIT
    assert all(run == {"orientation_histogram": 4, "descriptor_histogram": 4}
               for run in extra["launches"])


@pytest.mark.parametrize("B", [1, 2, 3, 8])
def test_feature_batch_gives_the_same_features_on_card(card, B,
                                                       monkeypatch):
    """OPENPANO_FEATURE_BATCH on the card: the features of 6 views of
    640x480 equal those of the default batch (4) bit for bit, and K1 and
    K2 launch once per batch."""
    from openpano_torch import Config
    from openpano_torch.bench.profile_sift import feature_views
    from openpano_torch.stitch.stitcherbase import compute_features

    u8 = torch.from_numpy(feature_views(6, 640, 480)).to(card)
    cfg = Config(MAX_KP_PER_IMAGE=1024)
    monkeypatch.delenv("OPENPANO_FEATURE_BATCH", raising=False)
    want = compute_features(u8, cfg)
    monkeypatch.setenv("OPENPANO_FEATURE_BATCH", str(B))
    k1 = windows.orientation_histogram.launches
    k2 = windows.descriptor_histogram.launches
    got = compute_features(u8, cfg)
    assert windows.orientation_histogram.launches - k1 == -(-6 // B)
    assert windows.descriptor_histogram.launches - k2 == -(-6 // B)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_match_precision_high_on_card(card, monkeypatch, capsys):
    """OPENPANO_MATCH_PRECISION=high (TF32 for the distance matrix's cross
    term) against unset (full f32) on the headline's first two views:
    prints how many 2-NN selections and accepted matches move; gates only
    that both run and that the default is full f32 again afterwards."""
    from openpano_torch.bench.headline import config, headline_inputs
    from openpano_torch.match import matcher
    from openpano_torch.stitch.stitcherbase import compute_features

    cfg = config()
    u8 = headline_inputs()[0][:2]
    f = compute_features(torch.from_numpy(u8).to(card), cfg)
    d, v = f.desc, f.valid

    def run():
        d2 = matcher._sq_dist_matrix(d[:1], d[1:], v[:1], v[1:])
        return matcher._top2(d2), matcher.match_pair(d[0], v[0], d[1], v[1],
                                                     cfg)

    monkeypatch.delenv("OPENPANO_MATCH_PRECISION", raising=False)
    (f1, f2), full = run()
    monkeypatch.setenv("OPENPANO_MATCH_PRECISION", "high")
    (h1, h2), high = run()
    assert torch.get_float32_matmul_precision() == "highest"
    live = v[0]
    moved_1nn = int(((f1[0] != h1[0]) & live).sum())
    moved_2nn = int(((f2[0] != h2[0]) & live).sum())
    pairs = lambda m: {tuple(p) for p in m.idx[0][m.valid[0]].tolist()}
    a, b = pairs(full), pairs(high)
    with capsys.disabled():
        print(f"\nmatch precision high vs full f32: {int(live.sum())} "
              f"keypoints, 1-NN moved {moved_1nn}, 2nd-NN moved {moved_2nn}; "
              f"matches {len(a)} / {len(b)}, {len(a ^ b)} differ")
    assert len(a) > 100 and len(b) > 100
