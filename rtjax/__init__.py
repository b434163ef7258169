"""rtjax — a wavefront path tracer for NVIDIA GPUs, built on JAX.

A framework with the capabilities of the CUDA reference ``lashhw/rtcuda``
(see SURVEY.md): a wavefront path tracer with NEE + MIS + Russian roulette
over a sweep-SAH BVH, matte/mirror/glass materials, point and area lights,
a pinhole camera, PLY loading and PPM output — as one jitted JAX program
per frame (SoA arrays, masked wavefronts, deterministic scatter-add
accumulation, ``shard_map`` scaling across devices) whose BVH walk is a
CUDA kernel called through ``jax.ffi`` (rtjax.kernels.native_walk).
"""

from .config import RenderConfig
from .scene import (Camera, Mesh, Scene, SceneBuilder, Transform, load_ply,
                    rotate, scale, translate)
from .render import render, render_frame, write_ppm
from . import constants

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "Camera", "Mesh", "Scene", "SceneBuilder", "Transform",
    "load_ply", "rotate", "scale", "translate", "render", "render_frame",
    "write_ppm",
    "constants",
]
