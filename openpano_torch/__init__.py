"""openpano_torch: the panorama stitcher in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

A port of ``openpano_tpu`` (the JAX reference, which stays unchanged beside
it).  This package imports neither JAX nor anything of ``openpano_tpu``.  It
runs every stitching mode on one device — the default ESTIMATE_CAMERA mode
(SIFT features, all-pairs 2-NN matching, perspective RANSAC, camera
estimation with the incremental bundle adjustment, the spherical blend),
TRANS, the naive flat mode and CYLINDER (cylindrical pre-warp, h-factor
search, affine chain, perspective correction) — with the linear or the
multiband blender, on the card; the CPU runs the kernels' plain versions
when asked for (``device="cpu"``), which is what the parity tests do.  A
uint8 stack too large for the device budget stays in host memory and blends
band by band (``stitch/stitcher.py``).  ``python -m openpano_torch.cli`` is
the command line, with the reference's debug modes.  ``mesh=`` shards a
stitch over ``torch.distributed`` ranks (``parallel/``).
"""

import itertools

from .config import DEFAULT, Config

__version__ = "0.1.0"
__all__ = ["Config", "DEFAULT", "stitch_images", "stitch_files", "__version__"]

_calls = itertools.count()   # stitch_images calls in this process


def stitch_images(imgs, cfg: Config | None = None, key=None,
                  output: str = "f32", device=None,
                  info_out: dict | None = None, mesh=None):
    """Stitch an [N, H, W, 3] image stack (uint8, or float32 in [0, 1]).

    Dispatches on the mode like the reference's work() (main.cc:205-235):
    CYLINDER to the cylinder stitcher, the rest to the general one.  Runs
    on the card unless ``device`` names another; raises when there is no
    card and none was named.  Returns the blended f32 canvas, or
    ``(canvas_u8, valid_mask)`` with ``output="u8"``.  ``info_out`` (a dict)
    collects run metadata: keypoint counts, the homographies and the render
    plan; the match graph, the cameras and bundle adjustment statistics in
    the general modes; the chosen h-factor, its slope and the number of
    trials in CYLINDER mode.

    ``mesh`` (``parallel.make_mesh``) shards every stage of the general
    modes over ``torch.distributed`` ranks (``stitch.stitcher.stitch``).
    In CYLINDER mode the mesh is dropped and the cylinder stitcher runs on
    ``device``, as the JAX package's ``stitch_images`` does; call
    ``stitch_cylinder(mesh=...)`` to shard that mode.

    Under ``torch.profiler`` the call is the range ``openpano:stitch``
    (its argument the call's sequence number in the process), and every
    stage and substage an ``openpano:`` range inside it
    (``utils.timer.span``)."""
    from .utils.timer import span

    cfg = cfg or DEFAULT
    with span("stitch", str(next(_calls))):
        if cfg.CYLINDER:
            from .stitch.cylstitcher import stitch_cylinder

            return stitch_cylinder(imgs, cfg, key, output=output,
                                   device=device, info_out=info_out)
        from .stitch.stitcher import stitch

        return stitch(imgs, cfg, key, output=output, device=device,
                      info_out=info_out, mesh=mesh)


def stitch_files(paths, cfg: Config | None = None, out: str | None = None,
                 key=None, crop: bool | None = None, device=None):
    """Stitch image files into a panorama; optionally write it to ``out``.

    Decodes each file to uint8 RGB, stitches (images of mixed sizes through
    ``stitch_hetero``), crops to the largest valid rectangle (``cfg.CROP``
    unless ``crop`` says otherwise), writes ``out`` if given, and returns
    the uint8 RGB canvas.  ``device`` as for :func:`stitch_images`."""
    import numpy as np

    from .io.image import read_img_u8, write_rgb
    from .ops.imgproc import crop_with_mask

    cfg = cfg or DEFAULT
    imgs = [read_img_u8(p) for p in paths]
    if len({im.shape for im in imgs}) == 1:
        canvas, valid = stitch_images(np.stack(imgs), cfg, key=key,
                                      output="u8", device=device)
    else:
        if cfg.CYLINDER:
            raise ValueError("CYLINDER mode requires uniform image sizes")
        from .stitch.stitcher import stitch_hetero

        canvas, valid = stitch_hetero(imgs, cfg, key=key, output="u8",
                                      device=device)
    if crop if crop is not None else cfg.CROP:
        canvas = crop_with_mask(canvas, valid)
    if out:
        write_rgb(out, canvas)
    return canvas
