"""Vector math over ``[..., 3]`` float32 arrays.

Equivalent of the reference's ``Vec3`` (vec3.cuh).
Instead of a 3-float struct with operator overloads, every function here is a
pure jnp function over arrays whose trailing axis has length 3, so the same
code path vectorizes over millions of rays and stays fully
traceable under ``jit`` / ``vmap`` / ``shard_map``.

``Vec3::atomic_add`` (vec3.cuh:149-153) has no equivalent here on purpose:
framebuffer accumulation is a deterministic ``segment_sum`` / scatter-add in
:mod:`rtjax.render.film`, which replaces nondeterministic float atomics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def vec3(x, y, z, dtype=jnp.float32):
    """Build a ``[..., 3]`` array from components (broadcasting)."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)), axis=-1)


def dot(a, b):
    """Per-vector dot product: ``[..., 3] x [..., 3] -> [...]`` (vec3.cuh:61-63)."""
    return jnp.sum(a * b, axis=-1)


def abs_dot(a, b):
    """|dot(a, b)| (utility.cuh:49-51)."""
    return jnp.abs(dot(a, b))


def cross(a, b):
    """Per-vector cross product (vec3.cuh:65-69)."""
    return jnp.cross(a, b)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v):
    """Unit vector, mirroring ``Vec3::unit_vector`` (vec3.cuh:131-134).

    Uses 1/length like the reference (not rsqrt) for closest numerics.
    """
    return v * (1.0 / length(v))[..., None]


def vmax(v):
    """Max component, ``Vec3::max`` (vec3.cuh:18)."""
    return jnp.max(v, axis=-1)


def reflect(v, unit_n):
    """Mirror reflection of ``v`` about ``unit_n`` (vec3.cuh:71-73)."""
    return v - 2.0 * dot(v, unit_n)[..., None] * unit_n


def refract(unit_v, unit_n, eta_ratio, cos_theta):
    """Refraction with precomputed incident cosine (vec3.cuh:82-86).

    ``cos_theta`` is the (positive) cosine between ``-unit_v`` and ``unit_n``.
    Caller guarantees no total internal reflection (the TIR branch is handled
    in the material model, material.cuh:81-87).
    """
    eta_ratio = jnp.asarray(eta_ratio, unit_v.dtype)
    v_parallel = eta_ratio[..., None] * (unit_v + cos_theta[..., None] * unit_n)
    # Guard the sqrt: masked-out lanes may carry garbage that would produce
    # NaNs and poison unrelated lanes through where-gradients.
    perp_sq = jnp.maximum(1.0 - length_squared(v_parallel), 0.0)
    v_perp = -jnp.sqrt(perp_sq)[..., None] * unit_n
    return v_parallel + v_perp
