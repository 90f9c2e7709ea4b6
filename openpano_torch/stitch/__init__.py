"""Projections, the render plan, the blends and the stitchers
(``openpano_tpu.stitch``'s public names)."""

from .cylstitcher import stitch_cylinder
from .projection import PROJECTIONS
from .render import RenderPlan, blend_linear, plan_render
from .warp import CylinderProjector

__all__ = [
    "PROJECTIONS",
    "RenderPlan",
    "plan_render",
    "blend_linear",
    "CylinderProjector",
    "stitch_cylinder",
]
