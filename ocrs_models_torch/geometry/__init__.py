"""Host geometry of the serving postprocess: connected-component word
quads and their expansion (C++ core with numpy versions)."""

from .components import connected_components, extract_cc_quads
from .polygon import expand_quad, expand_quads, min_area_rect

__all__ = [
    "connected_components",
    "extract_cc_quads",
    "expand_quad",
    "expand_quads",
    "min_area_rect",
]
