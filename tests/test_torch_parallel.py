"""Port parity for the sharded stitch over ``torch.distributed`` ranks.

The ranks are gloo processes on the CPU, spawned by
``openpano_torch.parallel.spawn.run_ranks`` (one intra-op thread each, a
``file://`` store in ``tmp_path``, a time limit that ends every rank), one
spawn per world size (1, 2 and 3 ranks; 3 pads both the images and the
pairs), each returning every result this file needs
(``tests/torch_mesh_ranks.py``, which imports no JAX).  This process holds
the references: the port on one device, and the JAX package on the 8
virtual CPU devices of ``tests/conftest.py``.

Gates:
- the whole stitch of 5 shuffled u8 views of ``procedural_scene_large``
  (the SMALL caps of tests/test_torch_stitch_camera.py) at 1, 2 and 3
  ranks against the port on one device: keypoint sets and the match
  graph's ``conf`` equal, focal within 1e-6, R within 1e-8, valid masks
  agreeing on >= 99.95%, canvas mean |diff| < 1e-6 and max < 1e-4 (the
  gates of tests/test_parallel.py:36-80); every rank returns the same
  canvas bit for bit;
- the slice against the JAX package through the ``graph=`` entry (no JAX
  feature pipeline): the port's graph as matchinfo text, read by both
  packages; JAX's ``stitch(mesh=make_mesh(2))`` against the port's at 2
  ranks: focal rel 1e-6, R 1e-6 (the estimator's parity in
  tests/test_torch_camera.py), canvas within 1e-4 but at the knife-edge
  pixels where the port's one-device blend of JAX's render plan already
  departs from JAX's canvas by more (1 pixel of 229,703 here, by 1.85e-4,
  ROADMAP Queue 3), where the mesh canvas is that blend within 1e-5;
- the sharded LM against JAX's ``ba_optimize_pairs_sharded`` on 8 virtual
  devices, on tests/test_torch_camera.py's ``_pair_problem`` (dense and
  banded, adaptive or not) and on the problem of
  tests/test_parallel.py:232-283 (dense, adaptive or not): equal
  iterations, parameters within rel 1e-8 (as ``test_lm_pass_matches_jax``);
  under ``OPENPANO_CHECK_NUMERICS=1`` a NaN in rank 0's pairs alone makes
  every rank raise ``NumericsError`` within seconds (no rank waits in a
  collective until the group's time limit);
- ``stitch_hetero(mesh=)`` (three image shapes) at 2 and 3 ranks against
  the port's one-device ``stitch_hetero``, at the rank-count gates; a
  ``device`` other than the mesh's raises; the stitch enters through
  ``stitch_images(mesh=)`` at 1 and 3 ranks and ``stitch_sharded`` at 2;
- CYLINDER: ``stitch_cylinder(mesh=)`` at 1 and 2 ranks gives the port's
  single-device canvas at the rank-count gates; ``stitch_images(mesh=)``
  in CYLINDER mode drops the mesh, as the JAX package's does: no
  collective runs and the canvas is the single-device one;
- the bootstrap: ``init_distributed`` is a no-op once up, ``make_mesh`` is
  the same mesh twice and refuses another size, ``device="cpu"`` gives
  gloo, and with no card and no device named ``init_distributed`` raises.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
import torch_mesh_ranks as ranks
from openpano_tpu.camera import bundle_adjuster as jba
from openpano_tpu.config import Config as JConfig
from openpano_tpu.io import artifacts as jart
from openpano_tpu.parallel.dist_ba import ba_optimize_pairs_sharded as jsharded
from openpano_tpu.parallel.mesh import make_mesh as jmake_mesh
from openpano_tpu.stitch.stitcher import stitch as jstitch
from openpano_torch import Config
from openpano_torch.camera.estimator import _np_unrod
from openpano_torch.io import artifacts as tart
from openpano_torch.parallel import mesh as pmesh
from openpano_torch.parallel.spawn import run_ranks
from openpano_torch.stitch import stitcher
from openpano_torch.stitch.cylstitcher import stitch_cylinder
from openpano_torch.stitch.render import blend_linear
from openpano_torch.stitch.stitcher import stitch
from openpano_torch.stitch.stitcherbase import feature_shards
from openpano_torch.synth import procedural_scene_large, render_views
from test_torch_camera import _pair_problem

SMALL = dict(RANSAC_ITERATIONS=400, MAX_CAND_PER_OCTAVE=1024,
             MAX_KP_PER_OCTAVE=512, MAX_DESC_PER_OCTAVE=512,
             MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=512,
             SIFT_WORKING_SIZE=400)
CYLINDER = dict(CYLINDER=True, ESTIMATE_CAMERA=False, ORDERED_INPUT=True,
                **SMALL)
WORLDS = (1, 2, 3)
# seconds each spawned group may take before every rank is ended
SPAWN_LIMIT_S = 300.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the ranks take one each):
    the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def u8(views):
    return np.round(views * 255).astype(np.uint8)


def rotating_views():
    """5 u8 views of 320x240 of a yawing camera, shuffled (the unordered
    all-pairs path)."""
    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    return u8(views[[2, 0, 4, 1, 3]])


def hetero_views(views):
    """The 5 views with two cropped: three shapes, three feature buckets."""
    return [views[0][:200, :280], views[1], views[2][:220], views[3],
            views[4]]


def cylinder_views():
    """6 u8 views in sweep order (the CYLINDER scene of
    tests/test_torch_cylinder.py, seed 2)."""
    views, _ = render_views(procedural_scene_large(600, 2400, seed=2), 6,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    return u8(views)


def parallel_problem():
    """The problem of tests/test_parallel.py:232-283: 6 cameras, chain and
    skip pairs, exact matches, the focal 8% off."""
    rng = np.random.default_rng(42)
    n, M, f = 6, 64, 500.0
    rot = lambda th: np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                               [-np.sin(th), 0, np.cos(th)]])
    Rs = [rot(0.3 * (i - n / 2)) for i in range(n)]
    K = np.diag([f, f, 1.0])
    pairs = [(i, i + 1) for i in range(n - 1)] + \
        [(i, i + 2) for i in range(n - 2)]
    P = len(pairs)
    pt_to, pt_from = np.zeros((P, M, 2)), np.zeros((P, M, 2))
    for s, (i, j) in enumerate(pairs):
        Hij = K @ Rs[i] @ Rs[j].T @ np.linalg.inv(K)
        p_j = rng.uniform(-200, 200, size=(M, 2))
        hp = np.concatenate([p_j, np.ones((M, 1))], 1) @ Hij.T
        pt_to[s], pt_from[s] = hp[:, :2] / hp[:, 2:3], p_j
    params = np.zeros((n, 6))
    params[:, 0] = f * 1.08
    for i in range(n):
        params[i, 3:6] = _np_unrod(Rs[i])
    arrays = dict(pt_to=pt_to, pt_from=pt_from, w=np.ones((P, M)),
                  cam_to=np.asarray([p[0] for p in pairs], np.int64),
                  cam_from=np.asarray([p[1] for p in pairs], np.int64),
                  swapped=np.zeros(P, bool), pair_w=np.ones(P))
    return arrays, params, 0, n


def lm_cases():
    """(arrays, params, identity, n, kwargs) for the sharded LM."""
    params, _, tprob, n = _pair_problem(3)
    arrays = {k: getattr(tprob, k).numpy() for k in tprob._fields}
    short = dict(max_iter=40, patience=5)
    cases = [(arrays, params, n // 2, n, dict(adaptive=a, banded=b, **short))
             for a, b in ((True, False), (False, False), (True, True),
                          (False, True))]
    arrays, params, identity, n = parallel_problem()
    cases += [(arrays, params, identity, n, dict(adaptive=a))
              for a in (False, True)]
    return cases


@pytest.fixture(scope="module")
def single():
    """The port on one device: the stitch (with its graph and features) and
    the CYLINDER stitch."""
    views = rotating_views()
    info = {}
    real = stitcher.compute_features
    real_up = stitcher.upload_and_compute_features
    feats = []

    def upload(*a, **k):            # a uint8 stack takes the transport
        imgs, f = real_up(*a, **k)
        feats.append(f)
        return imgs, f

    stitcher.compute_features = lambda *a: feats.append(real(*a)) or feats[0]
    stitcher.upload_and_compute_features = upload
    try:
        canvas = stitch(views, Config(**SMALL), device="cpu", info_out=info)
    finally:
        stitcher.compute_features = real
        stitcher.upload_and_compute_features = real_up
    info.update(pos=feats[0].pos.numpy(), valid=feats[0].valid.numpy())
    cyl = stitch_cylinder(cylinder_views(), Config(**CYLINDER),
                          device="cpu")
    hinfo = {}
    hetero = stitcher.stitch_hetero(hetero_views(views), Config(**SMALL),
                                    device="cpu", info_out=hinfo)
    return dict(views=views, canvas=canvas, info=info, cylinder=cyl,
                hetero=(hetero, hinfo))


@pytest.fixture(scope="module")
def ranked(single, tmp_path_factory):
    """world -> every rank's results (rank order)."""
    store = str(tmp_path_factory.mktemp("store"))
    cases = lm_cases()
    out = {}
    for world in WORLDS:
        args = (single["views"], SMALL,
                single["info"]["graph"] if world == 2 else None,
                hetero_views(single["views"]) if world > 1 else None,
                cylinder_views() if world < 3 else None, CYLINDER, cases)
        out[world] = run_ranks(ranks.stitch_suite, world, store, args=args,
                               timeout_s=SPAWN_LIMIT_S)
    return out


def assert_rank_count_gates(got, want):
    """tests/test_parallel.py:53-63: valid masks on >= 99.95%, canvas mean
    |diff| < 1e-6 and max < 1e-4 where both are valid."""
    assert got.shape == want.shape
    vg, vw = got[..., 0] >= 0, want[..., 0] >= 0
    assert (vg == vw).mean() >= 0.9995
    d = np.abs(got[vg & vw] - want[vg & vw])
    assert (vg & vw).mean() > 0.3
    assert d.mean() < 1e-6 and d.max() < 1e-4, (d.mean(), d.max())


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(ranked, world):
    assert not any(r["jax_loaded"] for r in ranked[world])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(ranked, world):
    first = ranked[world][0]
    for other in ranked[world][1:]:
        for part in ("stitch", "cylinder", "graph", "hetero"):
            if part in first:
                np.testing.assert_array_equal(other[part]["canvas"],
                                              first[part]["canvas"])
        for (p0, i0), (p1, i1) in zip(first["lm"], other["lm"]):
            assert i0 == i1
            np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("world", WORLDS)
def test_stitch_matches_single_device(ranked, single, world):
    got = ranked[world][0]["stitch"]
    info = single["info"]
    np.testing.assert_array_equal(got["conf"], info["graph"].conf)
    np.testing.assert_array_equal(got["valid"], info["valid"])
    np.testing.assert_array_equal(got["pos"], info["pos"])
    assert np.abs(got["focal"] - info["cams"].focal).max() < 1e-6
    assert np.abs(got["R"] - info["cams"].R).max() < 1e-8
    assert_rank_count_gates(got["canvas"], single["canvas"])


@pytest.mark.parametrize("world", WORLDS[1:])
def test_stitch_rank_count_independent(ranked, world):
    """n ranks against 1: the same keypoint sets and match graph, the
    cameras and canvas within the JAX package's mesh gates."""
    one, got = ranked[1][0]["stitch"], ranked[world][0]["stitch"]
    np.testing.assert_array_equal(got["valid"], one["valid"])
    np.testing.assert_array_equal(got["pos"], one["pos"])
    np.testing.assert_array_equal(got["conf"], one["conf"])
    assert got["lm_iters"] == one["lm_iters"]
    assert np.abs(got["focal"] - one["focal"]).max() < 1e-6
    assert np.abs(got["R"] - one["R"]).max() < 1e-8
    assert_rank_count_gates(got["canvas"], one["canvas"])


def test_graph_stitch_matches_jax_mesh(ranked, single, tmp_path):
    """The port's graph as matchinfo text, read by both packages; JAX's
    stitch(graph=, mesh=make_mesh(2)) against the port's at 2 ranks."""
    path = str(tmp_path / "matchinfo.txt")
    tart.dump_matchinfo_text(path, single["info"]["graph"])
    jgraph = jart.load_matchinfo_text(path, 5, SMALL["MAX_MATCHES_PER_PAIR"])
    jinfo = {}
    want = np.asarray(jstitch(single["views"], JConfig(**SMALL),
                              key=jax.random.PRNGKey(0), graph=jgraph,
                              mesh=jmake_mesh(2), info_out=jinfo))
    got = ranked[2][0]["graph"]
    jc = jinfo["cams"]
    assert np.abs(got["focal"] / jc.focal - 1).max() < 1e-6
    np.testing.assert_allclose(got["R"], jc.R, rtol=0, atol=1e-6)
    assert got["lm_iters"] == jinfo["lm_iters"]
    canvas = got["canvas"]
    assert canvas.shape == want.shape
    vg, vw = canvas[..., 0] >= 0, want[..., 0] >= 0
    assert (vg == vw).mean() >= 0.9995
    both = vg & vw
    d = np.abs(canvas - want).max(-1)
    # the port's one-device blend of JAX's own render plan departs from
    # JAX's canvas by more than 1e-4 at knife edges only: a sample that
    # sits within ~1e-5 px of an image's last row on one side (XLA:CPU's
    # contractions, ROADMAP Queue 3) flips in or out with its small weight:
    # one pixel on this set
    one = blend_linear(torch.from_numpy(single["views"]).float() / 255.0,
                       jinfo["plan"], ordered=False).numpy()
    edge = both & (np.abs(one - want).max(-1) > 1e-4)
    assert edge.sum() <= 1
    assert d[both & ~edge].max() <= 1e-4
    np.testing.assert_allclose(canvas[edge], one[edge], rtol=0, atol=1e-5)


def _jax_lm(case):
    arrays, params, identity, n, kw = case
    prob = jba.BAPairProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    p, iters = jsharded(params, prob, identity, n, 5.0, jmake_mesh(8),
                        return_iters=True, **kw)
    return np.asarray(p), int(iters)


@pytest.fixture(scope="module")
def jax_lm():
    return [_jax_lm(c) for c in lm_cases()]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(6))
def test_sharded_lm_matches_jax(ranked, jax_lm, world, case):
    got, iters = ranked[world][0]["lm"][case]
    want, want_iters = jax_lm[case]
    assert iters == want_iters
    assert iters > 3
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-8


@pytest.mark.parametrize("world", WORLDS)
def test_lm_nan_on_one_rank_raises_on_every_rank(ranked, world):
    """The residuals' non-finite count rides in the cost's all-reduce, so
    the ranks whose own residuals are finite raise with rank 0."""
    for raised, seconds in (r["lm_nan"] for r in ranked[world]):
        assert raised is not None
        assert re.fullmatch(r"\[ba_lm\[None\] iteration 0\] 'residuals' "
                            r"has [1-9]\d* non-finite values over the ranks",
                            raised), raised
        assert seconds < SPAWN_LIMIT_S / 10


@pytest.mark.parametrize("world", WORLDS[1:])
def test_stitch_hetero_matches_single_device(ranked, single, world):
    """Mixed sizes: the bucketed features on every rank, the rest sharded."""
    got = ranked[world][0]["hetero"]
    canvas, info = single["hetero"]
    np.testing.assert_array_equal(got["conf"], info["graph"].conf)
    assert np.abs(got["focal"] - info["cams"].focal).max() < 1e-6
    assert np.abs(got["R"] - info["cams"].R).max() < 1e-8
    assert_rank_count_gates(got["canvas"], canvas)


@pytest.mark.parametrize("world", WORLDS)
def test_a_device_other_than_the_mesh_raises(ranked, world):
    assert "conflicts with the mesh" in ranked[world][0]["other_device"]


@pytest.mark.parametrize("world", WORLDS[:2])
def test_cylinder_matches_single_device(ranked, single, world):
    assert_rank_count_gates(ranked[world][0]["cylinder"]["canvas"],
                            single["cylinder"])


def test_stitch_images_drops_the_mesh_in_cylinder_mode(ranked, single):
    """As the JAX package's stitch_images: CYLINDER runs unsharded."""
    got = ranked[1][0]
    assert got["cylinder_images_bytes"] == {}
    np.testing.assert_array_equal(got["cylinder_images"], single["cylinder"])


@pytest.mark.parametrize("world", WORLDS)
def test_bootstrap(ranked, world):
    got = ranked[world][0]["bootstrap"]
    assert got == dict(backend="gloo", world=world, same_mesh=True,
                       device="cpu", refuses_other_size=True)


def test_init_distributed_needs_a_card_or_a_device(monkeypatch):
    """No card and no device named: it raises, as the stitch entry points
    do, and no process group comes up."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed()
    assert not dist.is_initialized()


def test_shard_on_pads_to_a_mesh_multiple():
    class Mesh:
        def __init__(self, r):
            self.r = r

        def size(self):
            return 3

        def get_local_rank(self):
            return self.r

    blocks = [pmesh.shard_on(Mesh(r), 7) for r in range(3)]
    assert blocks == [range(0, 3), range(3, 6), range(6, 9)]


def test_feature_shards_follow_the_jax_devices():
    """Rank g computes the images JAX's device g takes: a batch of at most
    FEATURE_BATCH (4) per rank splits evenly, a larger one in chunks of 4
    per rank; padding (copies) is -1."""
    np.testing.assert_array_equal(feature_shards(5, 2),
                                  [[0, 1, 2], [3, 4, -1]])
    np.testing.assert_array_equal(feature_shards(5, 3),
                                  [[0, 1], [2, 3], [4, -1]])
    np.testing.assert_array_equal(
        feature_shards(11, 2),
        [[0, 1, 2, 3, 8, 9, 10, -1], [4, 5, 6, 7, -1, -1, -1, -1]])
    one = feature_shards(38, 1)
    np.testing.assert_array_equal(one[0, :38], np.arange(38))
    assert (one[0, 38:] == -1).all() and one.shape == (1, 40)
