"""Vector math over component triples ``(x, y, z)`` of ``[N]`` arrays.

Component-wise twin of :mod:`rtjax.core.vec`.  The wavefront engine keeps
all per-lane vector state as component triples: every component is a
contiguous ``[N]`` array (coalesced for elementwise code and for the native
walk, which reads ray components directly); ``vec.py`` remains the public
``[..., 3]`` API for scene data and tests.

A "v3" is a plain 3-tuple of equal-shaped arrays; all ops broadcast like
jnp.  The function set mirrors the reference's Vec3 surface
(/root/reference/vec3.cuh) exactly like vec.py does.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "from_array", "to_array", "splat", "add", "sub", "mul", "scale",
    "neg", "dot", "abs_dot", "cross", "length_squared", "length",
    "normalize", "vmax", "where", "reflect", "refract", "isfinite",
]


def from_array(a):
    """``[..., 3]`` array -> component triple."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_array(v):
    """Component triple -> ``[..., 3]`` array."""
    return jnp.stack(jnp.broadcast_arrays(*v), axis=-1)


def splat(c):
    """Scalar/[3]-like -> triple of python/0-d scalars."""
    return (c[0], c[1], c[2])


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Hadamard product (vec3.cuh:100-104)."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(s, a):
    """Scalar * vector."""
    return (s * a[0], s * a[1], s * a[2])


def neg(a):
    return (-a[0], -a[1], -a[2])


def dot(a, b):
    """vec3.cuh:61-63."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def abs_dot(a, b):
    """utility.cuh:49-51."""
    return jnp.abs(dot(a, b))


def cross(a, b):
    """vec3.cuh:65-69."""
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def length_squared(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length_squared(a))


def normalize(a):
    """1/length like the reference (vec3.cuh:131-134), not rsqrt."""
    inv = 1.0 / length(a)
    return scale(inv, a)


def vmax(a):
    """Max component (vec3.cuh:18)."""
    return jnp.maximum(jnp.maximum(a[0], a[1]), a[2])


def where(mask, a, b):
    """Per-lane select; ``mask`` is ``[N]`` (no [..., None] broadcast)."""
    return (jnp.where(mask, a[0], b[0]),
            jnp.where(mask, a[1], b[1]),
            jnp.where(mask, a[2], b[2]))


def reflect(v, unit_n):
    """vec3.cuh:71-73."""
    d = 2.0 * dot(v, unit_n)
    return (v[0] - d * unit_n[0], v[1] - d * unit_n[1], v[2] - d * unit_n[2])


def refract(unit_v, unit_n, eta_ratio, cos_theta):
    """Refraction with precomputed incident cosine (vec3.cuh:82-86).

    Same guard as vec.refract: masked lanes may carry garbage; clamp the
    sqrt argument so NaNs cannot leak through selects.
    """
    par = scale(eta_ratio, add(unit_v, scale(cos_theta, unit_n)))
    perp_sq = jnp.maximum(1.0 - length_squared(par), 0.0)
    k = -jnp.sqrt(perp_sq)
    return add(par, scale(k, unit_n))


def isfinite(a):
    """All three components finite, per lane."""
    return jnp.isfinite(a[0]) & jnp.isfinite(a[1]) & jnp.isfinite(a[2])
