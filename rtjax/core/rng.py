"""Stateless, counter-based RNG for the wavefront engine.

The reference keeps one mutable cuRAND XORWOW state per path slot, seeded with
``curand_init(seed=1, sequence=slot_id)`` and explicitly round-tripped through
registers in each kernel (/root/reference/render.cuh:68-73,156,247).

The JAX equivalent is the counter-based threefry: instead of
2^20 mutable states we derive every uniform from ``(seed, draw_site, lane)``.
Each *draw site* (a static (iteration, purpose) pair) folds its id into the
base key once and then draws a whole ``[N]`` batch, giving one threefry sweep
per site per iteration — cheap, reproducible, and trivially shardable (each
chip folds in its device index).  Parity with cuRAND is statistical, not
bitwise, by design (SURVEY.md §7 hard part 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def make_key(seed: int) -> jax.Array:
    return jax.random.key(seed)


def site_key(base_key, iteration, site: int, num_sites: int = 32):
    """Key for draw site ``site`` of wavefront iteration ``iteration``.

    ``iteration`` may be a traced int32; ``site``/``num_sites`` are static.
    """
    return jax.random.fold_in(base_key, iteration * num_sites + site)


def uniform(base_key, iteration, site: int, shape) -> jax.Array:
    """Batch of U[0,1) float32 draws for one draw site."""
    return jax.random.uniform(site_key(base_key, iteration, site), shape, jnp.float32)


def uniform_block(base_key, iteration, num_sites: int, n: int) -> jax.Array:
    """All of an iteration's draw sites in ONE threefry sweep: ``[sites, n]``.

    One fold_in + one counter sweep instead of ``num_sites`` of each.
    """
    key = jax.random.fold_in(base_key, iteration)
    return jax.random.uniform(key, (num_sites, n), jnp.float32)


def bits_block(base_key, iteration, num_words: int, n: int) -> jax.Array:
    """Raw random words for one iteration: ``[num_words, n]`` uint32.

    The engine converts words to uniforms itself (u01/u01_pair below), so
    draw sites that only need 16-bit resolution — 2-D jitter pairs like the
    subpixel offset or light-surface barycentrics — share ONE word, cutting
    the per-iteration threefry sweep from 12 to 8 words (engine floor diet,
    round 4).  Threefry cost is linear in words generated.
    """
    key = jax.random.fold_in(base_key, iteration)
    return jax.random.bits(key, (num_words, n), jnp.uint32)


def u01(word) -> jax.Array:
    """uint32 word -> U[0,1) float32 with the standard 24-bit resolution
    (matches jax.random.uniform's mantissa-width draw)."""
    return (word >> 8).astype(jnp.float32) * jnp.float32(2 ** -24)


def u01_pair(word) -> tuple[jax.Array, jax.Array]:
    """uint32 word -> two independent U[0,1) float32 of 16-bit resolution.

    The halves of one threefry word are independent uniforms; 16 bits is
    ample for subpixel jitter (< 2^-16 px quantization) and light-triangle
    barycentrics.  Estimator parity is statistical, not bitwise (module
    docstring), so the quantization is within contract.
    """
    s = jnp.float32(2 ** -16)
    return ((word >> 16).astype(jnp.float32) * s,
            (word & jnp.uint32(0xffff)).astype(jnp.float32) * s)
