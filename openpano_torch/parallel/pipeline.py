"""The sharded pipeline's entry points (``openpano_tpu/parallel/
pipeline.py``).  Every stage of ``stitch`` shards over the mesh's one axis:

  stage                sharded over            collective
  -------------------  ----------------------  ------------------------------
  SIFT features        images                  all-gather of the Features
  match + RANSAC       pairs                   all-gather of each stage's
                                               results
  incremental LM BA    pair slots; cameras     f64 all-reduce of the normal
                       and solve replicated    equations and the cost's sums
  linear / multiband   canvas column bands     halo to the right neighbour
  blend                                        (multiband: its seam also
                                               back left); all-gather of
                                               the strips

The host-side planning (spanning tree, render plan) is the single-device
code, run on every rank.
"""

from __future__ import annotations

from ..config import Config
from ..stitch.stitcher import stitch


def stitch_sharded(imgs, cfg: Config, mesh, key=None, output: str = "f32",
                   info_out: dict | None = None):
    """``stitch(imgs, cfg, key, output, mesh=mesh)``: the sharded pipeline is
    the production pipeline, not another code path."""
    return stitch(imgs, cfg, key=key, output=output, mesh=mesh,
                  info_out=info_out)


def sharded_pipeline_step(imgs, whs, ii, jj, key, cfg: Config, mesh,
                          canvas_hw=None):
    """The JAX package's first-round entry point: the sharded stitch, whose
    canvas it returns as ``{"canvas": ...}``.  ``whs``, ``ii``, ``jj`` and
    ``canvas_hw`` are ignored: the pipeline derives them itself."""
    del whs, ii, jj, canvas_hw
    return {"canvas": stitch_sharded(imgs, cfg, mesh, key=key)}
