"""Ray sorting: the path state's compaction and locality order.

Sorting the pool by (continue?, origin Morton code, direction octant) before
each walk compacts live paths into a prefix and pushes dead lanes to the
back — the equivalent of the reference's CUB stream compaction
(render.cuh:348-364) — and places rays that walk similar BVH subtrees next
to each other.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _part1by2(x):
    """Spread 10 bits to every 3rd bit (standard Morton magic)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_keys(origin, direction, lo, hi, active):
    """int32 sort keys: 3-bit octant | 27-bit origin Morton (9 bits/axis).

    Inactive lanes get the maximum key so they sort to the back.
    """
    g = (origin - lo) / jnp.maximum(hi - lo, 1e-30)
    cell = jnp.clip((g * 511.0), 0.0, 511.0).astype(jnp.int32)
    m = (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
         | (_part1by2(cell[:, 2]) << 2))
    octant = ((direction[:, 0] < 0).astype(jnp.int32)
              | ((direction[:, 1] < 0).astype(jnp.int32) << 1)
              | ((direction[:, 2] < 0).astype(jnp.int32) << 2))
    key = (octant << 27) | m
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def ray_sort_keys_v3(origin, direction, lo, hi, active):
    """Component-triple form of :func:`ray_sort_keys` (engine hot path).

    ``origin``/``direction`` are (x, y, z) triples of ``[N]`` arrays;
    ``lo``/``hi`` are ``[3]`` scene-root bounds.
    """
    cells = []
    for k in range(3):
        g = (origin[k] - lo[k]) / jnp.maximum(hi[k] - lo[k], 1e-30)
        cells.append(jnp.clip(g * 511.0, 0.0, 511.0).astype(jnp.int32))
    m = (_part1by2(cells[0]) | (_part1by2(cells[1]) << 1)
         | (_part1by2(cells[2]) << 2))
    octant = ((direction[0] < 0).astype(jnp.int32)
              | ((direction[1] < 0).astype(jnp.int32) << 1)
              | ((direction[2] < 0).astype(jnp.int32) << 2))
    key = (octant << 27) | m
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def ray_sort_keys_prim_v3(prim, direction, active):
    """Component-triple form of :func:`ray_sort_keys_prim`."""
    octant = ((direction[0] < 0).astype(jnp.int32)
              | ((direction[1] < 0).astype(jnp.int32) << 1)
              | ((direction[2] < 0).astype(jnp.int32) << 2))
    key = (octant << 24) | jnp.clip(prim, 0, (1 << 24) - 1)
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def ray_sort_keys_pos_v3(origin, direction, lo, hi, active):
    """POSITION-major variant of :func:`ray_sort_keys_v3`:
    27-bit origin Morton | 3-bit octant.

    Bounce packets from one surface patch share the BVH path down to their
    leaf regardless of direction; octant-major keys scatter them across 8
    buckets.  Position-major keeps same-patch rays in one tile and uses the
    octant only as a tie-break within a Morton cell (the per-packet descent
    order then adapts via the packet-octant reversal bit)."""
    cells = []
    for k in range(3):
        g = (origin[k] - lo[k]) / jnp.maximum(hi[k] - lo[k], 1e-30)
        cells.append(jnp.clip(g * 511.0, 0.0, 511.0).astype(jnp.int32))
    m = (_part1by2(cells[0]) | (_part1by2(cells[1]) << 1)
         | (_part1by2(cells[2]) << 2))
    octant = ((direction[0] < 0).astype(jnp.int32)
              | ((direction[1] < 0).astype(jnp.int32) << 1)
              | ((direction[2] < 0).astype(jnp.int32) << 2))
    key = (m << 3) | octant
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def ray_sort_keys_prim_pos_v3(prim, direction, active):
    """PRIM-major tree-locality keys: origin-prim index | 3-bit octant.
    Leaf order == tree order, so consecutive prims share subtrees; the
    octant tie-break only orders rays within one triangle's patch."""
    octant = ((direction[0] < 0).astype(jnp.int32)
              | ((direction[1] < 0).astype(jnp.int32) << 1)
              | ((direction[2] < 0).astype(jnp.int32) << 2))
    key = (jnp.clip(prim, 0, (1 << 24) - 1) << 3) | octant
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def ray_sort_keys_prim(prim, direction, active):
    """Tree-locality sort keys: 3-bit octant | origin primitive index.

    For bounce rays the triangle they left (leaf order == tree order) is a
    sharper locality signal than a quantized Morton code; camera rays
    (prim = -1) keep their generation order via the stable sort.
    """
    octant = ((direction[:, 0] < 0).astype(jnp.int32)
              | ((direction[:, 1] < 0).astype(jnp.int32) << 1)
              | ((direction[:, 2] < 0).astype(jnp.int32) << 2))
    key = (octant << 24) | jnp.clip(prim, 0, (1 << 24) - 1)
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def sort_permutation(keys):
    """Stable argsort + inverse (for scattering results back)."""
    perm = jnp.argsort(keys, stable=True)
    inv = jnp.zeros_like(perm).at[perm].set(
        jnp.arange(perm.shape[0], dtype=perm.dtype))
    return perm, inv


def sort_pytree_by_key(keys, tree):
    """Reorder every array in ``tree`` by ascending ``keys`` using ONE
    multi-operand ``lax.sort``.

    This is the engine's whole compaction step: a single variadic sort
    moves all per-slot state with vectorized compare-exchange passes,
    where applying an argsort permutation array-by-array costs one gather
    per array.  ``[N, K]`` leaves
    are split into K ``[N]`` columns (lax.sort requires same-shaped
    operands); bools ride as int8.  Stable, so equal keys preserve slot
    order (deterministic images).
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    cols = []
    meta = []  # (ndim-2 width or None, dtype-was-bool)
    for x in leaves:
        if x.ndim == 2:
            for i in range(x.shape[1]):
                cols.append(x[:, i])
            meta.append((x.shape[1], False))
        elif x.dtype == jnp.bool_:
            cols.append(x.astype(jnp.int8))
            meta.append((None, True))
        else:
            cols.append(x)
            meta.append((None, False))
    out = jax.lax.sort((keys,) + tuple(cols), num_keys=1, is_stable=True)
    sorted_cols = list(out[1:])
    new_leaves = []
    pos = 0
    for width, was_bool in meta:
        if width is not None:
            new_leaves.append(jnp.stack(sorted_cols[pos:pos + width], axis=1))
            pos += width
        else:
            c = sorted_cols[pos]
            new_leaves.append(c != 0 if was_bool else c)
            pos += 1
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def oct_encode_v3(n):
    """Component-triple direction -> ONE int32 (16+16-bit octahedral).

    The sort bundle's normal costs 3 of its payload columns and the only
    post-sort consumer normalizes it anyway (wavefront's n_g), so the
    direction survives the permutation as a 16-bit octahedral pair: max
    angular error ~2^-15 rad, invisible next to the estimator's own shot
    noise.  Zero vectors (dead lanes) encode to the +Z pole — every
    consumer is mat-masked.  Parity mode keeps the exact f32 triple."""
    l1 = jnp.abs(n[0]) + jnp.abs(n[1]) + jnp.abs(n[2])
    inv = 1.0 / jnp.maximum(l1, jnp.float32(1e-37))
    px, py = n[0] * inv, n[1] * inv
    sx = jnp.where(px >= 0, jnp.float32(1), jnp.float32(-1))
    sy = jnp.where(py >= 0, jnp.float32(1), jnp.float32(-1))
    fold = n[2] < 0
    px, py = (jnp.where(fold, (1.0 - jnp.abs(py)) * sx, px),
              jnp.where(fold, (1.0 - jnp.abs(px)) * sy, py))
    qx = jnp.clip((px + 1.0) * 32767.5, 0, 65535).astype(jnp.int32)
    qy = jnp.clip((py + 1.0) * 32767.5, 0, 65535).astype(jnp.int32)
    return (qx << 16) | qy


def oct_decode_v3(w):
    """Inverse of :func:`oct_encode_v3`; returns an UNNORMALIZED triple
    (consumers normalize, matching the raw cross-product contract)."""
    s = jnp.float32(2.0 / 65535.0)
    px = ((w >> 16) & 0xFFFF).astype(jnp.float32) * s - 1.0
    py = (w & 0xFFFF).astype(jnp.float32) * s - 1.0
    z = 1.0 - jnp.abs(px) - jnp.abs(py)
    t = jnp.clip(-z, 0.0, 1.0)
    px = px + jnp.where(px >= 0, -t, t)
    py = py + jnp.where(py >= 0, -t, t)
    return (px, py, z)


def _part1by2_10(x):
    """Spread 10 bits to every 3rd bit (same magic; kept separate for the
    10-bit key so the 9-bit paths stay untouched)."""
    return _part1by2(x)


def ray_sort_keys_pos10_v3(origin, direction, lo, hi, active):
    """Finer position-major keys: 30-bit origin Morton (10 bits/axis), NO
    octant tie-break.  Trades direction grouping within a cell for 8x
    smaller cells — an experiment for bounce-packet locality (the 9-bit
    grid is ~2 scene-units/512 per cell; divergent bounce packets may gain
    more from tighter origins than from direction bucketing)."""
    cells = []
    for k in range(3):
        g = (origin[k] - lo[k]) / jnp.maximum(hi[k] - lo[k], 1e-30)
        cells.append(jnp.clip(g * 1023.0, 0.0, 1023.0).astype(jnp.int32))
    m = (_part1by2_10(cells[0]) | (_part1by2_10(cells[1]) << 1)
         | (_part1by2_10(cells[2]) << 2))
    return jnp.where(active, m, jnp.int32(0x7FFFFFFF))


def _octant3_v3(direction):
    return ((direction[0] < 0).astype(jnp.int32)
            | ((direction[1] < 0).astype(jnp.int32) << 1)
            | ((direction[2] < 0).astype(jnp.int32) << 2))


def ray_sort_keys_normal_pos_v3(origin, normal, lo, hi, active):
    """Position-major keys with a NORMAL-octant tie-break.

    The sort runs BEFORE the mat stage samples the next direction
    (wavefront.py), so the incoming ray direction is a weak proxy for the
    next packet's direction spread; for matte bounces (the majority) the
    sampled direction is cosine-distributed around the shading normal, so
    the normal's octant is the sharper grouping signal within a Morton
    cell."""
    cells = []
    for k in range(3):
        g = (origin[k] - lo[k]) / jnp.maximum(hi[k] - lo[k], 1e-30)
        cells.append(jnp.clip(g * 511.0, 0.0, 511.0).astype(jnp.int32))
    m = (_part1by2(cells[0]) | (_part1by2(cells[1]) << 1)
         | (_part1by2(cells[2]) << 2))
    key = (m << 3) | _octant3_v3(normal)
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def ray_sort_keys_adaptive_v3(origin, normal, bounces, lo, hi, active,
                              deep_from=2):
    """Depth-adaptive keys: position-major for shallow rays, normal-octant-
    MAJOR for deep ones.

    Shallow bounce packets inherit camera coherence — same-patch origins
    share the BVH path, so position-major wins (PERF_NOTES round 3).  From
    ``deep_from`` bounces the directions are near-isotropic: a tile built
    from one Morton cell then unions rays fanning into the whole scene.
    Deep rays instead group by the normal octant first (hemisphere-coherent
    packets, cone-shaped unions) with the Morton cell as tie-break.  A top
    bit segregates the two classes so one global stable sort keeps each
    regime's tiles pure."""
    cells = []
    for k in range(3):
        g = (origin[k] - lo[k]) / jnp.maximum(hi[k] - lo[k], 1e-30)
        cells.append(jnp.clip(g * 511.0, 0.0, 511.0).astype(jnp.int32))
    m = (_part1by2(cells[0]) | (_part1by2(cells[1]) << 1)
         | (_part1by2(cells[2]) << 2))
    oc = _octant3_v3(normal)
    deep = bounces >= deep_from
    key = jnp.where(deep, (1 << 30) | (oc << 27) | m, (m << 3) | oc)
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


def rgb9e5_encode_v3(v):
    """Non-negative component triple -> ONE int32 (shared-exponent RGB9E5).

    The sort bundle's beta and acc triples only feed statistical math
    (throughput products, radiance sums), so they survive the permutation
    as 9-bit mantissas under a shared 5-bit exponent — max relative error
    2^-9 on the dominant channel per re-encode, far below shot noise.
    Negative/NaN inputs clamp to 0, values above the format max (~65408)
    saturate.  Parity mode keeps the exact f32 triples."""
    maxv = jnp.float32(511.0 / 512.0 * 65536.0)
    san = lambda c: jnp.clip(jnp.where(jnp.isfinite(c), c, 0.0), 0.0, maxv)
    r, g, b = san(v[0]), san(v[1]), san(v[2])
    m = jnp.maximum(jnp.maximum(r, g), b)
    # floor(log2(m)) off the f32 exponent field; m == 0 encodes to word 0
    eb = (jax.lax.bitcast_convert_type(jnp.maximum(m, jnp.float32(2e-10)),
                                       jnp.int32) >> 23) & 0xFF
    es = jnp.clip(eb - 127, -16, 15) + 1          # shared exp, unbiased
    # scale = 2^(es - 9), built exactly from the exponent bits
    scale = jax.lax.bitcast_convert_type((es + 118) << 23, jnp.float32)
    bump = jnp.maximum(jnp.maximum(jnp.round(r / scale), jnp.round(g / scale)),
                       jnp.round(b / scale)) >= 512.0
    es = jnp.where(bump, es + 1, es)
    scale = jnp.where(bump, scale * 2.0, scale)
    enc = lambda c: jnp.minimum(jnp.round(c / scale), 511.0).astype(jnp.int32)
    return enc(r) | (enc(g) << 9) | (enc(b) << 18) | ((es + 15) << 27)


def rgb9e5_decode_v3(w):
    """Inverse of :func:`rgb9e5_encode_v3` (exact for encoded values)."""
    es = (w >> 27) & 31
    scale = jax.lax.bitcast_convert_type((es + 103) << 23, jnp.float32)
    return ((w & 511).astype(jnp.float32) * scale,
            ((w >> 9) & 511).astype(jnp.float32) * scale,
            ((w >> 18) & 511).astype(jnp.float32) * scale)
