"""Sampling routines and MIS helpers.

Equivalents of the reference's utility.cuh plus the triangle area
sampler from triangle.cuh:78-82.  All functions are pure and
batched over leading axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import TWO_PI
from . import v3, vec

# Wachter & Binder, "A Fast and Robust Method for Avoiding Self-Intersection"
# (utility.cuh:31-47): nudge the spawn origin along the geometric normal by an
# integer number of ULPs, with a fixed-point fallback near zero.
_INT_SCALE = 256.0
_FLOAT_SCALE = 1.0 / 65536.0
_ORIGIN = 1.0 / 32.0


def _offset_component(p, n):
    of_i = jnp.trunc(_INT_SCALE * n).astype(jnp.int32)
    p_bits = jax.lax.bitcast_convert_type(p, jnp.int32)
    nudged_bits = p_bits + jnp.where(p < 0.0, -of_i, of_i)
    p_i = jax.lax.bitcast_convert_type(nudged_bits, jnp.float32)
    return jnp.where(jnp.abs(p) < _ORIGIN, p + _FLOAT_SCALE * n, p_i)


def offset_ray_origin_v3(p, unit_n):
    """Component-triple form of :func:`offset_ray_origin` (engine hot path)."""
    return tuple(_offset_component(pk, nk) for pk, nk in zip(p, unit_n))


def offset_ray_origin(p, unit_n):
    """Robust self-intersection offset (utility.cuh:31-47).

    ``__int_as_float/__float_as_int`` become ``lax.bitcast_convert_type``;
    the component-wise branches become ``jnp.where`` selects.
    """
    return _offset_component(p, unit_n)


def power_heuristic(f_pdf, g_pdf):
    """Power heuristic (beta=2) MIS weight (utility.cuh:53-56).

    The reference declares ``g_pdf`` as ``int`` — an accidental truncation bug
    flagged in SURVEY.md; here both pdfs are float as intended.
    """
    f2 = f_pdf * f_pdf
    return f2 / (f2 + g_pdf * g_pdf)


def same_hemisphere(wo, wi, n):
    """True when wo (pointing INTO the surface) and wi straddle n (utility.cuh:58-60)."""
    return vec.dot(wo, n) * vec.dot(wi, n) < 0.0


def same_hemisphere_v3(wo, wi, n):
    """Component-triple form of :func:`same_hemisphere`."""
    return v3.dot(wo, n) * v3.dot(wi, n) < 0.0


def uniform_sample_sphere_v3(u1, u2):
    """Component-triple form of :func:`uniform_sample_sphere`."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return (r * jnp.cos(phi), r * jnp.sin(phi), z)


def uniform_sample_sphere(u1, u2):
    """Uniform direction on the unit sphere from two uniforms (utility.cuh:70-77)."""
    return vec.vec3(*uniform_sample_sphere_v3(u1, u2))


def random_in_unit_sphere(key, shape):
    """Rejection-free equivalent of the reference's rejection sampler
    (utility.cuh:19-28, unused in its pipeline; kept for API parity).

    Uniform points INSIDE the unit sphere via radius ~ cbrt(U).
    """
    import jax
    k1, k2, k3 = jax.random.split(key, 3)
    d = uniform_sample_sphere(jax.random.uniform(k1, shape),
                              jax.random.uniform(k2, shape))
    r = jnp.cbrt(jax.random.uniform(k3, shape))
    return d * r[..., None]


def uniform_sample_disk(u1, u2):
    """Uniform point on the unit disk (utility.cuh:62-68). Returns (x, y)."""
    r = jnp.sqrt(u1)
    theta = TWO_PI * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def sample_triangle_barycentric(u1, u2):
    """Uniform barycentric (u, v) on a triangle (triangle.cuh:78-82).

    Matches the reference parameterization: ``a = sqrt(u1)``, point at
    ``(u, v) = (1 - a, u2 * a)`` where the triangle point is
    ``p(u, v) = p0 - u*e1 + v*e2``.
    """
    a = jnp.sqrt(u1)
    return 1.0 - a, u2 * a
