"""Ray-BVH traversal — the XLA walk, the plain reference.

Rebuild of the reference's device traversal (bvh.cuh:221-357 +
device_stack.cuh) in plain JAX.  The CUDA version is a per-thread
pointer-chasing loop with a 29-entry stack; here each ray is a
``lax.while_loop`` over dense node arrays with a fixed-size index stack,
``vmap``-ed over the wavefront — XLA batches the loop into
"iterate-until-all-lanes-done" with masked updates and lowers the per-lane
node reads to gathers.

The native walk (kernels/native_walk.py, one thread per ray) keeps the same
visit order, so both give the same hits and the same walk counters:
- ordered descent: nearer child first, farther pushed (entry compare,
  bvh.cuh:284-290),
- leaves intersected inline, shrinking ray tmax (bvh.cuh:222-236),
- the slab test does NOT clip against [0, tmax] (aabb_intersector.cuh:24-36),
- any-hit excludes one triangle by identity — an int32 index compare instead
  of pointer equality (bvh.cuh:243) — and exits on the first hit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..accel.bvh import BvhArrays
from ..constants import BVH_MAX_DEPTH
from ..core.geometry import Triangles, intersect_triangle, ray_slab_precompute

# numpy, not jnp: a module-level jnp scalar would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize()
# (multi-host requires init before any backend touch)
import numpy as np  # noqa: E402

_SENTINEL = np.int32(-1)


def _leaf_closest(bvh, tris, origin, direction, enabled, node, state):
    """Intersect all primitives of a leaf, shrinking tmax (bvh.cuh:222-236).

    ``enabled=False`` zeroes the trip count so disabled lanes do no work.
    """
    tmax, hit, t, u, v, prim = state
    first = bvh.left_first[node]
    count = jnp.where(enabled, bvh.num_prims[node], 0)

    def body(carry):
        i, tmax, hit, t, u, v, prim = carry
        ti = first + i
        h, tt, uu, vv = intersect_triangle(
            origin, direction, tmax, tris.p0[ti], tris.e1[ti], tris.e2[ti],
            tris.n[ti])
        tmax = jnp.where(h, tt, tmax)   # ray.tmax = isect.t on hit
        t = jnp.where(h, tt, t)
        u = jnp.where(h, uu, u)
        v = jnp.where(h, vv, v)
        prim = jnp.where(h, ti, prim)
        hit = hit | h
        return i + 1, tmax, hit, t, u, v, prim

    out = jax.lax.while_loop(
        lambda c: c[0] < count, body, (jnp.int32(0), tmax, hit, t, u, v, prim))
    return out[1:]


def _leaf_anyhit(bvh, tris, origin, direction, tmax, exclude, enabled, node):
    """Any-hit over a leaf, skipping the excluded triangle (bvh.cuh:239-248)."""
    first = bvh.left_first[node]
    count = jnp.where(enabled, bvh.num_prims[node], 0)

    def body(carry):
        i, occluded = carry
        ti = first + i
        h, _, _, _ = intersect_triangle(
            origin, direction, tmax, tris.p0[ti], tris.e1[ti], tris.e2[ti],
            tris.n[ti])
        return i + 1, occluded | (h & (ti != exclude))

    def cond(carry):
        return (carry[0] < count) & ~carry[1]

    _, occluded = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.bool_(False)))
    return occluded


def _make_slab(bvh, origin, direction):
    """Per-ray precomputed slab test (aabb_intersector.cuh:14-36)."""
    inv_d, sc_o, neg_d = ray_slab_precompute(direction, origin)

    def slab(node):
        near = jnp.where(neg_d, bvh.bmax[node], bvh.bmin[node])
        far = jnp.where(neg_d, bvh.bmin[node], bvh.bmax[node])
        entry = jnp.max(inv_d * near + sc_o)
        exit_ = jnp.min(inv_d * far + sc_o)
        return entry <= exit_, entry

    return slab


def _next_node(live_l, live_r, entry_l, entry_r, child_l, child_r, sp, stack,
               done):
    """Shared descent/push/pop logic (bvh.cuh:282-299)."""
    both = live_l & live_r
    l_far = entry_l > entry_r
    push_val = jnp.where(l_far, child_l, child_r)
    next_both = jnp.where(l_far, child_r, child_l)

    pop_needed = ~live_l & ~live_r
    can_pop = sp > 0
    done = done | (pop_needed & ~can_pop)

    new_sp = jnp.where(both, sp + 1,
                       jnp.where(pop_needed & can_pop, sp - 1, sp))
    stack = jnp.where(both, stack.at[sp].set(push_val), stack)
    popped = stack[jnp.maximum(new_sp, 0)]

    cur = jnp.where(both, next_both,
                    jnp.where(live_l, child_l,
                              jnp.where(live_r, child_r, popped)))
    return cur, new_sp, stack, done


def _traverse_one_closest(bvh, tris, stack_size, origin, direction, tmax,
                          active):
    """Closest-hit traversal for a single ray (bvh.cuh:251-303).

    Node 0 is guaranteed internal (BuildResult.to_device pads leaf roots),
    so there is no per-ray root branch — a vmapped ``lax.cond`` on a batched
    predicate would broadcast the captured scene arrays per lane.
    """
    slab = _make_slab(bvh, origin, direction)
    no_hit = (tmax, jnp.bool_(False), jnp.float32(jnp.inf), jnp.float32(0),
              jnp.float32(0), _SENTINEL)

    def body(carry):
        cur, sp, stack, tmax, hit, t, u, v, prim, done, steps, leafs = carry
        left, right = cur, cur + 1

        ok_l, entry_l = slab(left)
        ok_r, entry_r = slab(right)
        leaf_l = bvh.num_prims[left] > 0
        leaf_r = bvh.num_prims[right] > 0

        steps = steps + 1
        leafs = leafs + (ok_l & leaf_l) + (ok_r & leaf_r)

        # consume leaf children inline; left first, right sees shrunk tmax
        state = (tmax, hit, t, u, v, prim)
        state = _leaf_closest(bvh, tris, origin, direction,
                              ok_l & leaf_l, left, state)
        state = _leaf_closest(bvh, tris, origin, direction,
                              ok_r & leaf_r, right, state)
        tmax, hit, t, u, v, prim = state

        cur, sp, stack, done = _next_node(
            ok_l & ~leaf_l, ok_r & ~leaf_r, entry_l, entry_r,
            bvh.left_first[left], bvh.left_first[right], sp, stack, done)
        return cur, sp, stack, tmax, hit, t, u, v, prim, done, steps, leafs

    stack = jnp.full((stack_size,), _SENTINEL)
    init = (bvh.left_first[0], jnp.int32(0), stack) + no_hit + \
        (jnp.bool_(~active), jnp.int32(0), jnp.int32(0))
    out = jax.lax.while_loop(lambda c: ~c[9], body, init)
    return out[4], out[5], out[6], out[7], out[8], out[10], out[11]


def _traverse_one_anyhit(bvh, tris, stack_size, origin, direction, tmax,
                         exclude, active):
    """Any-hit traversal with excluded triangle (bvh.cuh:306-357).

    Node 0 is guaranteed internal (see _traverse_one_closest).
    """
    slab = _make_slab(bvh, origin, direction)

    def body(carry):
        cur, sp, stack, occluded, done, steps, leafs = carry
        left, right = cur, cur + 1

        ok_l, entry_l = slab(left)
        ok_r, entry_r = slab(right)
        leaf_l = bvh.num_prims[left] > 0
        leaf_r = bvh.num_prims[right] > 0

        steps = steps + 1
        leafs = leafs + (ok_l & leaf_l) + (ok_r & leaf_r)

        occluded = occluded | _leaf_anyhit(
            bvh, tris, origin, direction, tmax, exclude, ok_l & leaf_l, left)
        occluded = occluded | _leaf_anyhit(
            bvh, tris, origin, direction, tmax, exclude, ok_r & leaf_r, right)
        done = done | occluded  # first-hit early exit (bvh.cuh:318,328)

        cur, sp, stack, done = _next_node(
            ok_l & ~leaf_l, ok_r & ~leaf_r, entry_l, entry_r,
            bvh.left_first[left], bvh.left_first[right], sp, stack, done)
        return cur, sp, stack, occluded, done, steps, leafs

    stack = jnp.full((stack_size,), _SENTINEL)
    init = (bvh.left_first[0], jnp.int32(0), stack, jnp.bool_(False),
            jnp.bool_(~active), jnp.int32(0), jnp.int32(0))
    out = jax.lax.while_loop(lambda c: ~c[4], body, init)
    return out[3], out[5], out[6]


@partial(jax.jit, static_argnames=("stack_size", "with_stats"))
def traverse_closest(bvh: BvhArrays, tris: Triangles, origin, direction,
                     tmax, active, stack_size: int = BVH_MAX_DEPTH,
                     with_stats: bool = False):
    """Batched closest-hit traversal.

    Args:
      origin/direction: ``[N, 3]`` rays.
      tmax: ``[N]`` max distance.
      active: ``[N]`` bool; inactive lanes are skipped and return miss.

    Returns ``(hit, t, u, v, prim, normal)``; ``prim`` is the global
    (leaf-order) triangle index or -1, ``normal [N, 3]`` the hit triangle's
    unnormalized geometric normal (zero on miss) — the native walk's
    contract plus ``u``/``v``.  With ``with_stats=True`` a trailing
    ``(node_pair_steps, leaf_visits)`` int32 scalar pair is appended
    (summed over rays).
    """
    fn = partial(_traverse_one_closest, bvh, tris, stack_size)
    hit, t, u, v, prim, steps, leafs = jax.vmap(fn)(origin, direction, tmax,
                                                    active)
    hit = hit & active
    normal = jnp.where(hit[:, None],
                       tris.n[jnp.clip(prim, 0, tris.num - 1)], 0.0)
    out = (hit, t, u, v, prim, normal)
    if with_stats:
        out = out + ((jnp.sum(steps), jnp.sum(leafs)),)
    return out


@partial(jax.jit, static_argnames=("stack_size", "with_stats"))
def traverse_anyhit(bvh: BvhArrays, tris: Triangles, origin, direction,
                    tmax, exclude, active, stack_size: int = BVH_MAX_DEPTH,
                    with_stats: bool = False):
    """Batched any-hit (occlusion) traversal with per-ray excluded triangle.

    Returns ``occluded [N]`` (False for inactive lanes); with
    ``with_stats=True``, ``(occluded, (node_pair_steps, leaf_visits))``.
    """
    fn = partial(_traverse_one_anyhit, bvh, tris, stack_size)
    occ, steps, leafs = jax.vmap(fn)(origin, direction, tmax, exclude, active)
    occluded = occ & active
    if with_stats:
        return occluded, (jnp.sum(steps), jnp.sum(leafs))
    return occluded
