"""Flattened BVH arrays — the device-side acceleration structure.

Equivalent of the reference's ``Bvh`` node array (bvh.cuh:4-28).  The
pointer-linked node struct becomes four dense device arrays for the XLA
walk (the native walk packs the same nodes into 16-byte records,
kernels/native_walk.py):

- ``bmin``/``bmax [M, 3]``: child AABBs, split min/max (the reference's
  interleaved ``bounds[6]`` layout exists only to enable the per-octant index
  trick, which vectorized ``jnp.where(neg_dir, bmax, bmin)`` replaces).
- ``left_first [M]``: left-child index for internal nodes (children are
  always allocated adjacently: right = left + 1, bvh.cuh:153-154), or the
  first primitive index for leaves.
- ``num_prims [M]``: 0 for internal nodes; leaf primitive count otherwise.

Primitives are permuted into leaf order at build time (bvh.cuh:208), so a
leaf's primitives are the contiguous triangle indices
``[left_first, left_first + num_prims)``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.tree_util.register_dataclass,
         data_fields=["bmin", "bmax", "left_first", "num_prims"],
         meta_fields=["max_depth"])
@dataclasses.dataclass(frozen=True)
class BvhArrays:
    bmin: jax.Array        # [M, 3] float32
    bmax: jax.Array        # [M, 3] float32
    left_first: jax.Array  # [M] int32
    num_prims: jax.Array   # [M] int32
    # static: actual tree depth from the build.  The at-cap median split
    # (builder_np.py) can legally exceed BVH_MAX_DEPTH on degenerate scenes;
    # the XLA traversal sizes its stack from this so pushes are never
    # silently dropped.
    max_depth: int = 0

    @property
    def num_nodes(self) -> int:
        return self.bmin.shape[0]


@dataclasses.dataclass
class BuildResult:
    """Host-side output of a BVH build (NumPy arrays + stats)."""

    bmin: np.ndarray
    bmax: np.ndarray
    left_first: np.ndarray
    num_prims: np.ndarray
    perm: np.ndarray        # [P] original-triangle index per leaf-order slot
    num_nodes: int
    max_depth: int

    def padded_arrays(self):
        """Host node arrays ``(bmin, bmax, left_first, num_prims, depth)``
        with a leaf root wrapped so that node 0 is ALWAYS internal.

        The reference special-cases a leaf root in both traversals
        (bvh.cuh:252,307).  The walks here skip that branch instead: a
        vmapped ``lax.cond`` with per-lane predicates would broadcast every
        captured scene array per lane, so the root is padded:
        root -> [real leaf, dummy leaf with an inverted (never-hit) bbox].
        """
        m = self.num_nodes
        bmin = self.bmin[:m]
        bmax = self.bmax[:m]
        left_first = self.left_first[:m]
        num_prims = self.num_prims[:m]
        depth = int(self.max_depth)
        if num_prims[0] > 0:
            inf = np.float32(np.inf)
            bmin = np.concatenate([bmin[:1], bmin[:1], [[inf, inf, inf]]])
            bmax = np.concatenate([bmax[:1], bmax[:1], [[-inf, -inf, -inf]]])
            # node1 = the original leaf; node2 = never-hit dummy leaf
            left_first = np.array([1, left_first[0], 0], np.int32)
            num_prims = np.array([0, num_prims[0], 1], np.int32)
            depth += 1
        return (bmin.astype(np.float32), bmax.astype(np.float32),
                left_first.astype(np.int32), num_prims.astype(np.int32),
                depth)

    def to_device(self) -> BvhArrays:
        """Flattened device arrays of :meth:`padded_arrays`."""
        bmin, bmax, left_first, num_prims, depth = self.padded_arrays()
        return BvhArrays(
            bmin=jnp.asarray(bmin),
            bmax=jnp.asarray(bmax),
            left_first=jnp.asarray(left_first),
            num_prims=jnp.asarray(num_prims),
            max_depth=depth,
        )


def validate(res: BuildResult, tri_bmin: np.ndarray, tri_bmax: np.ndarray) -> None:
    """Structural invariants from bvh.cuh:5-13,153-154 (used by tests).

    - every primitive appears exactly once across leaves,
    - children are adjacent (right = left + 1) and within bounds,
    - every node's bbox contains the bboxes of its primitives.
    """
    m = res.num_nodes
    covered = np.zeros(len(res.perm), bool)

    def walk(node, depth):
        assert depth <= 64, "runaway depth"
        np_ = res.num_prims[node]
        if np_ > 0:
            first = res.left_first[node]
            assert not covered[first:first + np_].any(), "primitive covered twice"
            covered[first:first + np_] = True
            lo = tri_bmin[res.perm[first:first + np_]]
            hi = tri_bmax[res.perm[first:first + np_]]
            assert (res.bmin[node] <= lo.min(0) + 1e-6).all()
            assert (res.bmax[node] >= hi.max(0) - 1e-6).all()
        else:
            left = res.left_first[node]
            assert 0 < left and left + 1 < m, "child index out of range"
            for c in (left, left + 1):
                assert (res.bmin[node] <= res.bmin[c] + 1e-6).all()
                assert (res.bmax[node] >= res.bmax[c] - 1e-6).all()
            walk(left, depth + 1)
            walk(left + 1, depth + 1)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        walk(0, 0)
    finally:
        sys.setrecursionlimit(old)
    assert covered.all(), "some primitive not covered by any leaf"
