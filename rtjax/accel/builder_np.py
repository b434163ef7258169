"""NumPy full-sweep SAH BVH builder.

Pure-Python/NumPy implementation of the reference's host-side builder
(/root/reference/bvh.cuh:30-219), used as the portable fallback and as the
correctness oracle for the C++ extension (:mod:`rtjax.accel.builder_cpp`).

Algorithm parity with the reference:
- three axis-sorted index lists (bvh.cuh:72-87),
- explicit-stack top-down build (bvh.cuh:90-200),
- full-sweep SAH: suffix costs right-to-left, prefix scan left-to-right,
  min over all three axes (bvh.cuh:124-141) — here each sweep is a
  vectorized ``np.minimum.accumulate``/cumulative-extend over the range,
- leaf when count <= 1, depth cap, or ``best_cost >= half_area * (count-1)``
  (bvh.cuh:112,143-150),
- stable partition of the other two axis lists (bvh.cuh:161-175),
- children adjacent (right = left + 1), smaller subtree traversed first
  (bvh.cuh:153-154,186-199),
- primitives permuted into leaf order by the x-axis list (bvh.cuh:208).

One deliberate extension: ``max_leaf_size`` forces a split (at the SAH-best
index) even when the SAH cost test would create a leaf, bounding the work
of one leaf visit.
``max_leaf_size=None`` reproduces the reference exactly.
"""

from __future__ import annotations

import numpy as np

from ..constants import BVH_MAX_DEPTH
from .bvh import BuildResult


def _half_area(lo, hi):
    e = hi - lo
    return (e[..., 0] + e[..., 1]) * e[..., 2] + e[..., 0] * e[..., 1]


def build_bvh(tri_bmin: np.ndarray, tri_bmax: np.ndarray,
              centers: np.ndarray | None = None,
              max_depth: int = BVH_MAX_DEPTH,
              max_leaf_size: int | None = None,
              min_leaf_size: int = 1) -> BuildResult:
    """Build a binary sweep-SAH BVH over per-triangle AABBs.

    Args:
      tri_bmin/tri_bmax: ``[P, 3]`` float32 per-triangle bounds.
      centers: ``[P, 3]`` sort keys; the reference sorts by the triangle's
        vertex mean (triangle.cuh:11), so pass that for exact parity.
        Defaults to the bbox center.
      max_depth: depth cap (constant.hpp:7).
      max_leaf_size: optional forced-split bound (see module docstring).
      min_leaf_size: stop splitting once a range has <= this many prims.
        The reference always splits to ~1-2 prims/leaf (bvh.cuh:112); the
        scenes build with 8 (the 8-triangle leaf rule, inherited and not
        yet re-derived for the GPU walk: ROADMAP S6).  1 reproduces the
        reference exactly.

    Returns a :class:`BuildResult` whose ``perm`` maps leaf-order slot ->
    original triangle index.
    """
    tri_bmin = np.asarray(tri_bmin, np.float32)
    tri_bmax = np.asarray(tri_bmax, np.float32)
    p = len(tri_bmin)
    assert p >= 1

    if centers is None:
        centers = 0.5 * (tri_bmin + tri_bmax)
    centers = np.asarray(centers, np.float32)

    cap = 2 * p
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    left_first = np.zeros(cap, np.int32)
    num_prims = np.zeros(cap, np.int32)

    sorted_refs = np.stack([np.argsort(centers[:, a], kind="stable")
                            for a in range(3)], axis=0).astype(np.int64)

    bmin[0] = tri_bmin.min(axis=0)
    bmax[0] = tri_bmax.max(axis=0)
    num_nodes = 1
    out_max_depth = 0

    stack: list[tuple[int, int, int, int]] = []
    node, begin, end, depth = 0, 0, p, 0

    while True:
        count = end - begin
        at_cap = depth >= max_depth
        # at the depth cap, a range larger than max_leaf_size must still be
        # split (median, below) — the packet kernels require bounded leaves
        # and a degenerate scene can push 1|rest splits to the cap
        make_leaf = count <= min_leaf_size or (
            at_cap and (max_leaf_size is None or count <= max_leaf_size))
        best_axis = -1
        best_split = -1

        if not make_leaf and at_cap:
            ext = [float(centers[sorted_refs[a, end - 1], a]
                         - centers[sorted_refs[a, begin], a])
                   for a in range(3)]
            best_axis = int(np.argmax(ext))
            best_split = begin + count // 2
        elif not make_leaf:
            best_cost = np.inf
            for axis in range(3):
                idx = sorted_refs[axis, begin:end]
                lo = tri_bmin[idx]
                hi = tri_bmax[idx]
                # suffix: bbox of [i, end) for i in range(1, count)
                suf_lo = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
                suf_hi = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
                counts_r = np.arange(count, 0, -1, dtype=np.float32)
                suffix_cost = _half_area(suf_lo, suf_hi) * counts_r  # [count]
                # prefix: bbox of [begin, i] for i in range(count - 1)
                pre_lo = np.minimum.accumulate(lo, axis=0)
                pre_hi = np.maximum.accumulate(hi, axis=0)
                counts_l = np.arange(1, count + 1, dtype=np.float32)
                cost = (_half_area(pre_lo, pre_hi)[:-1] * counts_l[:-1]
                        + suffix_cost[1:])  # split after position i
                k = int(np.argmin(cost))
                if cost[k] < best_cost:
                    best_cost = float(cost[k])
                    best_axis = axis
                    best_split = begin + k + 1

            max_split_cost = _half_area(bmin[node], bmax[node]) * (count - 1)
            if best_cost >= max_split_cost:
                if max_leaf_size is None or count <= max_leaf_size:
                    make_leaf = True
                # else: forced split at best_split (leaf-size bound)

        if make_leaf:
            num_prims[node] = count
            left_first[node] = begin
            if not stack:
                break
            node, begin, end, depth = stack.pop()
            continue

        # child bboxes + marks over the best-axis order
        left_idx = sorted_refs[best_axis, begin:best_split]
        right_idx = sorted_refs[best_axis, best_split:end]
        lnode, rnode = num_nodes, num_nodes + 1
        bmin[lnode] = tri_bmin[left_idx].min(axis=0)
        bmax[lnode] = tri_bmax[left_idx].max(axis=0)
        bmin[rnode] = tri_bmin[right_idx].min(axis=0)
        bmax[rnode] = tri_bmax[right_idx].max(axis=0)

        marks = np.zeros(p, bool)
        marks[left_idx] = True

        # stable partition of the two other axis lists (bvh.cuh:168-175)
        for other in ((best_axis + 1) % 3, (best_axis + 2) % 3):
            seg = sorted_refs[other, begin:end]
            m = marks[seg]
            sorted_refs[other, begin:end] = np.concatenate([seg[m], seg[~m]])

        num_nodes += 2
        num_prims[node] = 0
        left_first[node] = lnode
        out_max_depth = max(out_max_depth, depth + 1)

        left_size = best_split - begin
        right_size = end - best_split
        if left_size < right_size:
            stack.append((rnode, best_split, end, depth + 1))
            node, begin, end, depth = lnode, begin, best_split, depth + 1
        else:
            stack.append((lnode, begin, best_split, depth + 1))
            node, begin, end, depth = rnode, best_split, end, depth + 1

    perm = sorted_refs[0].copy()
    return BuildResult(bmin=bmin, bmax=bmax, left_first=left_first,
                       num_prims=num_prims, perm=perm,
                       num_nodes=num_nodes, max_depth=out_max_depth)
