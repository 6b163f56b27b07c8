"""Rendering: the hard rasterizer (dense, binned, and binned over the
visibility kernel K2), SH shading, and the normal-map video writer."""

from .rasterizer import compute_vertex_normals, rasterize, rasterize_auto, render_normal_maps
from .shading import add_sh_light, render_shaded, sh_basis
from .visualizer import FixedViewRenderer, FlameVisualizer, save_frames_as_video

__all__ = [
    "FixedViewRenderer",
    "FlameVisualizer",
    "add_sh_light",
    "compute_vertex_normals",
    "rasterize",
    "rasterize_auto",
    "render_normal_maps",
    "render_shaded",
    "save_frames_as_video",
    "sh_basis",
]
