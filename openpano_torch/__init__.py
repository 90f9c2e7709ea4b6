"""openpano_torch: the panorama stitcher in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

A port of ``openpano_tpu`` (the JAX reference, which stays unchanged beside
it).  This package imports neither JAX nor anything of ``openpano_tpu``.  It
runs the TRANS mode of the general stitcher — SIFT features, ordered 2-NN
matching, affine RANSAC, homography chaining, flat projection and the
linear blend — on the card; the CPU runs the kernels' plain versions when
asked for (``device="cpu"``), which is what the parity tests do.
"""

from .config import DEFAULT, Config

__version__ = "0.1.0"
__all__ = ["Config", "DEFAULT", "stitch_images", "__version__"]


def stitch_images(imgs, cfg: Config | None = None, key=None,
                  output: str = "f32", device=None,
                  info_out: dict | None = None):
    """Stitch an [N, H, W, 3] image stack (uint8, or float32 in [0, 1]).

    Runs on the card unless ``device`` names another; raises when there is
    no card and none was named.  Configurations outside the ported slice
    (ESTIMATE_CAMERA — the ``Config()`` default —, CYLINDER, MULTIBAND > 0,
    the naive flat mode) raise NotImplementedError.  Returns the blended
    f32 canvas, or ``(canvas_u8, valid_mask)`` with ``output="u8"``.
    ``info_out`` (a dict) collects run metadata: keypoint counts, the match
    graph, the homographies and the render plan."""
    from .stitch.stitcher import stitch

    return stitch(imgs, cfg or DEFAULT, key, output=output, device=device,
                  info_out=info_out)
