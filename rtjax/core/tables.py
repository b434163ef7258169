"""Small-table row lookup as select chains instead of gathers.

For the framework's *small* tables — materials (a handful of rows,
material.cuh:20-22), lights (light.cuh:20-26), per-light emitter
triangles — a chain of vector selects over the rows is elementwise work
that fuses into its consumers, where a gather is a separate pass.  Above
``limit`` rows the chain grows too long, so the helper falls back to a
real gather.  (The select-vs-gather crossover was set on another device
and is not yet re-derived on the GPU: ROADMAP S6.)
"""

from __future__ import annotations

import jax.numpy as jnp

# rows up to which a select chain replaces the gather
SELECT_LIMIT = 16


def take_rows(table, idx, limit: int = SELECT_LIMIT):
    """``table[idx]`` for a table whose row count is small and static.

    ``table`` is ``[L, ...]``; ``idx`` any int array.  Returns rows with
    shape ``idx.shape + table.shape[1:]``.  Out-of-range indices clamp (the
    callers mask invalid lanes themselves).
    """
    L = table.shape[0]
    if L > limit:
        return table[jnp.clip(idx, 0, L - 1)]
    # clamp so the select chain agrees with the gather path above: without
    # it any out-of-range index silently mapped to row 0 (ADVICE r2 #5)
    idx = jnp.clip(idx, 0, L - 1)
    expand = (Ellipsis,) + (None,) * (table.ndim - 1)
    out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for l in range(1, L):
        out = jnp.where((idx == l)[expand], table[l], out)
    return out
