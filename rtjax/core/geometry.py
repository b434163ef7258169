"""Triangles, rays, and AABB intersection as batched pure functions.

Equivalents of the reference's triangle.cuh, ray.cuh, bounding_box.cuh
and aabb_intersector.cuh.  Structs-of-pointers become
structs-of-arrays (SoA pytrees); the per-thread intersection methods become
batched functions over ``[..., 3]`` arrays.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import v3, vec
from .sampling import offset_ray_origin, offset_ray_origin_v3

_FLT_EPSILON = float(np.finfo(np.float32).eps)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Triangles:
    """SoA triangle soup with precomputed edges (triangle.cuh:4-20).

    Same storage trick as the reference: ``e1 = p0 - p1``, ``e2 = p2 - p0``,
    ``n = cross(e1, e2)`` (unnormalized), so the hit test needs no vertex
    re-fetch and ``p(u, v) = p0 - u*e1 + v*e2``.
    """

    p0: jax.Array  # [N, 3]
    e1: jax.Array  # [N, 3]
    e2: jax.Array  # [N, 3]
    n: jax.Array   # [N, 3]

    @staticmethod
    def from_vertices(p0, p1, p2) -> "Triangles":
        p0 = jnp.asarray(p0, jnp.float32)
        p1 = jnp.asarray(p1, jnp.float32)
        p2 = jnp.asarray(p2, jnp.float32)
        e1 = p0 - p1
        e2 = p2 - p0
        return Triangles(p0=p0, e1=e1, e2=e2, n=jnp.cross(e1, e2))

    @property
    def num(self) -> int:
        return self.p0.shape[0]

    def p1(self):
        return self.p0 - self.e1

    def p2(self):
        return self.p0 + self.e2

    def center(self):
        return (self.p0 + self.p1() + self.p2()) / 3.0

    def point(self, u, v):
        """Barycentric point ``p(u, v) = p0 - u*e1 + v*e2`` (triangle.cuh:15)."""
        return self.p0 - u[..., None] * self.e1 + v[..., None] * self.e2

    def area(self):
        """0.5 * |n| (triangle.cuh:84-86)."""
        return 0.5 * vec.length(self.n)

    def bounds(self):
        """Per-triangle AABB as (min[N,3], max[N,3]) (triangle.cuh:22-37)."""
        ps = jnp.stack([self.p0, self.p1(), self.p2()], axis=0)
        return jnp.min(ps, axis=0), jnp.max(ps, axis=0)

    def gather(self, idx) -> "Triangles":
        """Gather a subset/reordering by index (batched)."""
        return Triangles(p0=self.p0[idx], e1=self.e1[idx],
                         e2=self.e2[idx], n=self.n[idx])


def intersect_triangle_v3(origin, direction, tmax, p0, e1, e2, n):
    """Component-triple form of :func:`intersect_triangle` (engine hot path).

    All vector args are (x, y, z) triples of ``[N]`` arrays (core.v3).
    """
    c = v3.sub(p0, origin)
    r = v3.cross(direction, c)
    inv_det = 1.0 / v3.dot(direction, n)
    u = inv_det * v3.dot(e2, r)
    v = inv_det * v3.dot(e1, r)
    t = inv_det * v3.dot(c, n)
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t <= tmax)
    return hit, t, u, v


def intersect_triangle(origin, direction, tmax, p0, e1, e2, n):
    """Batched Moeller-Trumbore variant (triangle.cuh:39-58).

    All args broadcast; returns ``(hit, t, u, v)`` with the exact accept rule
    of the reference: ``u >= 0 and v >= 0 and u + v <= 1 and 0 < t <= tmax``.
    Division by a zero determinant yields inf/nan which the comparisons
    reject, matching the CUDA behavior of ``1.f / dot(d, n)``.
    """
    return intersect_triangle_v3(
        v3.from_array(origin), v3.from_array(direction), tmax,
        v3.from_array(p0), v3.from_array(e1), v3.from_array(e2),
        v3.from_array(n))


def spawn_offset_ray_v3(p, unit_n, unit_d, tmax=jnp.inf):
    """Component-triple form of :func:`spawn_offset_ray`."""
    return (offset_ray_origin_v3(p, unit_n), unit_d,
            jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), p[0].shape))


def spawn_offset_ray(p, unit_n, unit_d, tmax=jnp.inf):
    """Offset ray spawn (ray.cuh:19-25): origin nudged off the surface."""
    return offset_ray_origin(p, unit_n), unit_d, jnp.broadcast_to(
        jnp.asarray(tmax, jnp.float32), p.shape[:-1])


def ray_slab_precompute(direction, origin):
    """Precomputed slab-test state (aabb_intersector.cuh:14-22).

    Returns ``(inv_dir, scaled_origin, neg_dir)`` where ``neg_dir`` is the
    per-axis octant (True when the direction component is negative).
    """
    safe_d = jnp.where(jnp.abs(direction) < _FLT_EPSILON,
                       jnp.copysign(_FLT_EPSILON, direction), direction)
    inv_dir = 1.0 / safe_d
    return inv_dir, -origin * inv_dir, direction < 0.0


def intersect_aabb(inv_dir, scaled_origin, neg_dir, box_min, box_max):
    """Batched slab test (aabb_intersector.cuh:24-36).

    Returns ``(overlap, entry)``; ``entry`` is the max of the per-axis entry
    distances.  Note: like the reference, this tests the infinite ray (no
    tmax/0 clipping) — the traversal relies on leaf tests for final accepts.
    """
    near = jnp.where(neg_dir, box_max, box_min)
    far = jnp.where(neg_dir, box_min, box_max)
    entry = jnp.max(inv_dir * near + scaled_origin, axis=-1)
    exit_ = jnp.min(inv_dir * far + scaled_origin, axis=-1)
    return entry <= exit_, entry
