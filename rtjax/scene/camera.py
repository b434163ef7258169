"""Pinhole camera.

Equivalent of the reference's camera.cuh.  The constructor
precompute is identical (camera.cuh:15-29), including the negated ``vertical``
so that image-space y grows downward; ``get_rays`` is the batched version of
``Camera::get_ray`` (camera.cuh:31-34) over arrays of normalized image
coordinates.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core import vec


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    lookfrom: jax.Array    # [3]
    upper_left: jax.Array  # [3]
    horizontal: jax.Array  # [3]
    vertical: jax.Array    # [3]

    @staticmethod
    def make(lookfrom, lookat, up, vfov_deg: float, aspect_ratio: float) -> "Camera":
        lookfrom = np.asarray(lookfrom, np.float32)
        lookat = np.asarray(lookat, np.float32)
        up = np.asarray(up, np.float32)

        vfov_rad = math.radians(float(vfov_deg))
        viewport_height = 2.0 * math.tan(vfov_rad * 0.5)
        viewport_width = viewport_height * float(aspect_ratio)

        w = lookfrom - lookat
        w = w / np.linalg.norm(w)
        v = up - np.dot(up, w) * w
        v = v / np.linalg.norm(v)
        u = np.cross(v, w)

        horizontal = np.float32(viewport_width) * u
        vertical = np.float32(-viewport_height) * v  # y grows downward
        upper_left = lookfrom - w - 0.5 * horizontal - 0.5 * vertical
        return Camera(
            lookfrom=jnp.asarray(lookfrom),
            upper_left=jnp.asarray(upper_left.astype(np.float32)),
            horizontal=jnp.asarray(horizontal.astype(np.float32)),
            vertical=jnp.asarray(vertical.astype(np.float32)),
        )

    def get_rays_v3(self, x, y):
        """Component-triple form of :func:`get_rays` (engine hot path)."""
        from ..core import v3
        d = tuple(self.upper_left[k] + x * self.horizontal[k]
                  + y * self.vertical[k] - self.lookfrom[k]
                  for k in range(3))
        d = v3.normalize(d)
        origin = tuple(jnp.broadcast_to(self.lookfrom[k], d[0].shape)
                       for k in range(3))
        return origin, d

    def get_rays(self, x, y):
        """Rays through normalized image coords ``x, y in [0, 1)`` (batched).

        Returns ``(origin[..., 3], unit_dir[..., 3])``.
        """
        d = (self.upper_left
             + x[..., None] * self.horizontal
             + y[..., None] * self.vertical
             - self.lookfrom)
        d = vec.normalize(d)
        origin = jnp.broadcast_to(self.lookfrom, d.shape)
        return origin, d
