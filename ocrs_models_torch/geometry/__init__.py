"""Host geometry of the serving postprocess and the detection trainer:
connected-component word quads and their expansion, detection masks and
box-match metrics (C++ core with numpy versions)."""

from .components import connected_components, extract_cc_quads
from .metrics import box_match_metrics
from .polygon import expand_quad, expand_quads, min_area_rect, shrink_polygon
from .raster import fill_polygon, generate_mask

__all__ = [
    "box_match_metrics",
    "connected_components",
    "extract_cc_quads",
    "expand_quad",
    "expand_quads",
    "fill_polygon",
    "generate_mask",
    "min_area_rect",
    "shrink_polygon",
]
