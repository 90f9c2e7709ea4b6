"""Sharded stitching over ``torch.distributed`` ranks: the process-group
bootstrap and the 1-D rank mesh (``mesh.py``), the pair-sharded bundle
adjustment (``dist_ba.py``), the sharded pipeline's entry points
(``pipeline.py``) and a launcher of CPU ranks for tests (``spawn.py``).
Counterpart of ``openpano_tpu/parallel``; torch needs no lazy import here,
since nothing starts a backend before ``init_distributed``."""

from .mesh import init_distributed, make_mesh
from .pipeline import sharded_pipeline_step, stitch_sharded

__all__ = ["init_distributed", "make_mesh", "sharded_pipeline_step",
           "stitch_sharded"]
