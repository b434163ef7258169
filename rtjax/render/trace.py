"""Unified scene tracing: walk dispatch + two-level (instanced) merge.

Gives the wavefront engine a single closest-hit/any-hit interface over
(a) the base one-level scene and (b) optional instanced meshes
(rtjax.accel.instancing).  Hits are identified by ``(src, prim)`` where
src 0 = base scene and src k = instance k-1 — the index-pair equivalent of
the reference's triangle-pointer identity (render.cuh:321, bvh.cuh:243).

Two walks serve every single-level query (``RenderConfig.traversal``):
"native" — the one-thread-per-ray walk called through ``jax.ffi``
(kernels/native_walk.py), built for the platform the program runs on —
and "xla", the vmapped while-loop walk (kernels/traversal.py) that is the
plain reference.  "auto" is "native".  Neither falls back to the other.

Ray origins/directions flow through as component triples (core.v3, the
engine's hot-path layout); ``[N, 3]`` arrays are accepted too and the
normal output matches the input convention.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import v3
from ..kernels import native_walk
from ..kernels.traversal import traverse_anyhit, traverse_closest

_FLT_EPSILON = float(np.finfo(np.float32).eps)

TRAVERSALS = ("auto", "native", "xla")


def resolve_mode(cfg) -> str:
    """The walk a render uses: "native" or "xla" ("auto" is "native")."""
    if cfg.traversal not in TRAVERSALS:
        raise ValueError(f"traversal must be one of {TRAVERSALS}, got "
                         f"{cfg.traversal!r}")
    return "xla" if cfg.traversal == "xla" else "native"


def _direct_closest(tris, o, d, tmax, active, with_stats):
    """Closest hit by an unrolled all-triangles MT loop (component
    triples, exact reference accept rule, triangle.cuh:39-58).  The
    trivially-small-scene fast path: every per-triangle constant is a
    static slice, so XLA fuses the whole loop into the surrounding
    iteration with no walk call and no [P]-table gather."""
    T = tris.num
    shape = tmax.shape
    best_t = jnp.full(shape, jnp.float32(BIG_T), jnp.float32)
    prim = jnp.full(shape, -1, jnp.int32)
    n_out = tuple(jnp.zeros(shape, jnp.float32) for _ in range(3))
    for k in range(T):
        p0 = tuple(tris.p0[k, c] for c in range(3))
        e1 = tuple(tris.e1[k, c] for c in range(3))
        e2 = tuple(tris.e2[k, c] for c in range(3))
        nv = tuple(tris.n[k, c] for c in range(3))
        cx = p0[0] - o[0]; cy = p0[1] - o[1]; cz = p0[2] - o[2]
        rx = d[1] * cz - d[2] * cy
        ry = d[2] * cx - d[0] * cz
        rz = d[0] * cy - d[1] * cx
        inv_det = 1.0 / (d[0] * nv[0] + d[1] * nv[1] + d[2] * nv[2])
        u = inv_det * (e2[0] * rx + e2[1] * ry + e2[2] * rz)
        v = inv_det * (e1[0] * rx + e1[1] * ry + e1[2] * rz)
        t = inv_det * (cx * nv[0] + cy * nv[1] + cz * nv[2])
        h = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & \
            (t <= tmax)
        closer = h & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        prim = jnp.where(closer, k, prim)
        n_out = tuple(jnp.where(closer, c, n) for c, n in zip(nv, n_out))
    hit = (prim >= 0) & active
    prim = jnp.where(hit, prim, -1)
    out = (hit, best_t, prim, n_out)
    if with_stats:
        visits = (jnp.sum(active, dtype=jnp.int32) * T).astype(jnp.int32)
        out = out + ((jnp.int32(0), visits),)
    return out


def _direct_anyhit(tris, o, d, tmax, exclude, active, with_stats):
    """Occlusion by the unrolled MT loop with per-lane prim exclusion
    (bvh.cuh:306-357 semantics, same accept rule as _direct_closest)."""
    T = tris.num
    occ = jnp.zeros(tmax.shape, bool)
    for k in range(T):
        p0 = tuple(tris.p0[k, c] for c in range(3))
        e1 = tuple(tris.e1[k, c] for c in range(3))
        e2 = tuple(tris.e2[k, c] for c in range(3))
        nv = tuple(tris.n[k, c] for c in range(3))
        cx = p0[0] - o[0]; cy = p0[1] - o[1]; cz = p0[2] - o[2]
        rx = d[1] * cz - d[2] * cy
        ry = d[2] * cx - d[0] * cz
        rz = d[0] * cy - d[1] * cx
        inv_det = 1.0 / (d[0] * nv[0] + d[1] * nv[1] + d[2] * nv[2])
        u = inv_det * (e2[0] * rx + e2[1] * ry + e2[2] * rz)
        v = inv_det * (e1[0] * rx + e1[1] * ry + e1[2] * rz)
        t = inv_det * (cx * nv[0] + cy * nv[1] + cz * nv[2])
        h = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & \
            (t <= tmax) & (exclude != k)
        occ = occ | h
    occ = occ & active
    if with_stats:
        visits = (jnp.sum(active, dtype=jnp.int32) * T).astype(jnp.int32)
        return occ, (jnp.int32(0), visits)
    return occ


BIG_T = 3.4e38


def _backend(mode, cfg, walk, bvh, tris, with_stats=False):
    """``(closest, anyhit)`` single-level walks over one BVH.

    ``closest(o, d, tmax, active)`` returns ``(hit, t, prim, normal)``
    (normal as a triple) and ``anyhit(o, d, tmax, exclude, active)`` the
    occlusion mask; with ``with_stats`` each appends its
    ``(node_pair_steps, leaf_visits)`` sums.
    """
    if mode == "native" and tris.num <= cfg.direct_max_tris:
        # a trivially small (base or BLAS) scene skips the BVH entirely
        return (partial(_direct_closest, tris, with_stats=with_stats),
                partial(_direct_anyhit, tris, with_stats=with_stats))
    # the at-cap median split can exceed BVH_MAX_DEPTH on degenerate scenes;
    # size the stack from the build's actual depth so pushes are never
    # dropped
    stack_size = max(cfg.stack_size, bvh.max_depth + 1)
    if mode == "native":
        return (partial(native_walk.closest, walk, stack_size=stack_size,
                        with_stats=with_stats),
                partial(native_walk.anyhit, walk, stack_size=stack_size,
                        with_stats=with_stats))

    def closest(o, d, tmax, active):
        # the XLA walk computes (u, v) too; drop them to match the native
        # walk's (hit, t, prim, normal) contract
        out = traverse_closest(bvh, tris, v3.to_array(o), v3.to_array(d),
                               tmax, active, stack_size=stack_size,
                               with_stats=with_stats)
        return out[:2] + (out[4], v3.from_array(out[5])) + out[6:]

    def anyhit(o, d, tmax, exclude, active):
        return traverse_anyhit(bvh, tris, v3.to_array(o), v3.to_array(d),
                               tmax, exclude, active, stack_size=stack_size,
                               with_stats=with_stats)

    return closest, anyhit


def _affine_point_v3(A, p):
    """[3, 4] affine row-matrix applied to a component-triple point."""
    return tuple(A[r, 0] * p[0] + A[r, 1] * p[1] + A[r, 2] * p[2] + A[r, 3]
                 for r in range(3))


def _affine_vector_v3(A, d):
    return tuple(A[r, 0] * d[0] + A[r, 1] * d[1] + A[r, 2] * d[2]
                 for r in range(3))


def _matvec_v3(M, n):
    """[3, 3] matrix applied to a component triple (cofactor normals)."""
    return tuple(M[r, 0] * n[0] + M[r, 1] * n[1] + M[r, 2] * n[2]
                 for r in range(3))


def _instance_entry_exit(inst, k, o, d):
    """Slab entry/exit distances of all rays vs instance k's world AABB."""
    lo, hi = inst.aabb_lo[k], inst.aabb_hi[k]
    entry, exit_ = None, None
    for c in range(3):
        safe = jnp.where(jnp.abs(d[c]) < _FLT_EPSILON,
                         jnp.copysign(_FLT_EPSILON, d[c]), d[c])
        inv = 1.0 / safe
        e0 = (lo[c] - o[c]) * inv
        e1 = (hi[c] - o[c]) * inv
        near = jnp.minimum(e0, e1)
        far = jnp.maximum(e0, e1)
        entry = near if entry is None else jnp.maximum(entry, near)
        exit_ = far if exit_ is None else jnp.minimum(exit_, far)
    return entry, exit_


def _instance_mask(inst, k, o, d):
    """Vector slab test of all rays vs instance k's world AABB (triples)."""
    entry, exit_ = _instance_entry_exit(inst, k, o, d)
    return entry <= exit_


def _mesh_groups(inst):
    """Static grouping of instance ids by mesh: ``{mesh_id: [k, ...]}``."""
    groups: dict[int, list[int]] = {}
    for k in range(inst.num):
        groups.setdefault(int(inst.mesh_id[k]), []).append(k)
    return groups


TWO_LEVEL = ("auto", "repass", "loop")


def _resolve_two_level(cfg, which="two_level") -> str:
    """Two-level strategy for instanced scenes: "repass" (multi-pass
    re-dispatch, _repass_closest) or "loop" (one masked walk per instance).
    "auto" picks repass; ``two_level_anyhit="auto"`` follows ``two_level``.
    """
    tl = getattr(cfg, which)
    if tl not in TWO_LEVEL:
        raise ValueError(f"{which} must be one of {TWO_LEVEL}, got {tl!r}")
    if tl == "auto":
        if which == "two_level_anyhit":
            return _resolve_two_level(cfg)
        return "repass"
    return tl


def _repass_setup(inst, ks, o, d):
    """Per-ray slab precompute for one mesh group: stacked entry distances
    ``ent [G, N]`` (clamped to 0 for inside-the-box origins) and the
    hit-the-box validity mask ``ok [G, N]``."""
    ents, oks = [], []
    for k in ks:
        entry, exit_ = _instance_entry_exit(inst, k, o, d)
        oks.append((entry <= exit_) & (exit_ >= 0.0))
        ents.append(jnp.maximum(entry, 0.0))
    return jnp.stack(ents), jnp.stack(oks)


def _repass_local_rays(inv_flat, pick, o, d):
    """Transform rays into their picked instance's local frame: ``inv_flat``
    is the group's ``[G, 12]`` affine table, ``pick`` the per-ray local
    group index.  take_rows keeps the lookup a <=16-row select chain."""
    from ..core.tables import take_rows
    # per-column selects keep everything [N]-shaped: 12 independent column
    # chains fuse into the surrounding elementwise code
    col = lambda c: take_rows(inv_flat[:, c], pick)
    o_l = tuple(col(4 * r + 0) * o[0] + col(4 * r + 1) * o[1]
                + col(4 * r + 2) * o[2] + col(4 * r + 3) for r in range(3))
    d_l = tuple(col(4 * r + 0) * d[0] + col(4 * r + 1) * d[1]
                + col(4 * r + 2) * d[2] for r in range(3))
    return o_l, d_l


def _repass_closest(scene, cfg, mode, o, d, tmax, active, with_stats):
    """Two-level closest hit by MULTI-PASS RE-DISPATCH: every pass, each ray
    picks its nearest not-yet-walked candidate instance (world-AABB slab
    entry < current t) and ALL rays walk that mesh's single-level BLAS in
    ONE call (rays transform per-ray into their own instance's local frame
    first — instances of one mesh share the tree).  Passes repeat until no
    ray has a live candidate; tmax shrinks globally between passes, so
    pass j+1 only runs the boundary rays whose next candidate is still
    closer than their best hit.

    Each pass costs one single-BLAS walk over the rays that still have a
    candidate, instead of one masked full-width walk per instance (the
    "loop" strategy in trace_closest).  The reference has no instancing;
    this is an extension (BASELINE.md config 4).
    Returns ``(hit, t, prim, src, n_local, steps, leafs)``; normals are
    LOCAL frame (caller applies the cofactor transform by src).
    """
    from ..core.tables import take_rows
    inst = scene.instances
    BIG = jnp.float32(3.0e38)

    # base scene: one plain single-level walk
    closest, _ = _backend(mode, cfg, scene.walk, scene.bvh, scene.tris,
                          with_stats)
    hit, t, prim, n_l, *st = closest(o, d, tmax, active)
    t = jnp.where(hit, t, tmax)
    src = jnp.zeros_like(prim)
    steps, leafs = (st[0][0], st[0][1]) if with_stats else (
        jnp.int32(0), jnp.int32(0))

    for mesh_id, ks in _mesh_groups(inst).items():
        blas = scene.blas[mesh_id]
        c_k, _ = _backend(mode, cfg, blas.walk, blas.bvh, blas.tris,
                          with_stats)
        G = len(ks)
        ent, ok = _repass_setup(inst, ks, o, d)          # [G, N]
        inv_flat = jnp.stack([inst.inv[k].reshape(12) for k in ks])
        src_of = jnp.asarray([k + 1 for k in ks], jnp.int32)
        g_iota = jnp.arange(G, dtype=jnp.int32)[:, None]

        def cand_of(t, walked):
            return ok & ~walked & (ent < t[None]) & active[None]

        def cond(c):
            return jnp.any(cand_of(c[0], c[7]))

        def body(c):
            t, prim, src, hit, n0, n1, n2, walked, steps, leafs = c
            cand = cand_of(t, walked)
            pend = jnp.any(cand, axis=0)
            pick = jnp.argmin(jnp.where(cand, ent, BIG), axis=0
                              ).astype(jnp.int32)
            walked = walked | ((g_iota == pick[None]) & pend[None])
            o_l, d_l = _repass_local_rays(inv_flat, pick, o, d)
            h2, t2, p2, nl2, *st2 = c_k(o_l, d_l, t, pend)
            if with_stats:
                steps = steps + st2[0][0]
                leafs = leafs + st2[0][1]
            closer = h2 & (t2 < t)
            t = jnp.where(closer, t2, t)
            prim = jnp.where(closer, p2, prim)
            src = jnp.where(closer, take_rows(src_of, pick), src)
            n0 = jnp.where(closer, nl2[0], n0)
            n1 = jnp.where(closer, nl2[1], n1)
            n2 = jnp.where(closer, nl2[2], n2)
            hit = hit | closer
            return (t, prim, src, hit, n0, n1, n2, walked, steps, leafs)

        walked0 = jnp.zeros((G,) + t.shape, bool)
        carry = (t, prim, src, hit, n_l[0], n_l[1], n_l[2], walked0,
                 steps, leafs)
        carry = jax.lax.while_loop(cond, body, carry)
        (t, prim, src, hit, nx, ny, nz, _, steps, leafs) = carry
        n_l = (nx, ny, nz)

    return hit, t, prim, src, n_l, steps, leafs


def _repass_anyhit(scene, cfg, mode, o, d, tmax, exclude, active,
                   with_stats):
    """Two-level any-hit by multi-pass re-dispatch (see _repass_closest).
    Exclusion applies only within the base scene (lights are never
    instanced); occluded rays drop out of later passes."""
    inst = scene.instances
    BIG = jnp.float32(3.0e38)
    _, anyhit = _backend(mode, cfg, scene.walk, scene.bvh, scene.tris,
                         with_stats)
    occ = anyhit(o, d, tmax, exclude, active)
    if with_stats:
        occ, (steps, leafs) = occ
    else:
        steps = leafs = jnp.int32(0)
    no_excl = jnp.full(tmax.shape, -1, jnp.int32)

    for mesh_id, ks in _mesh_groups(inst).items():
        blas = scene.blas[mesh_id]
        _, a_k = _backend(mode, cfg, blas.walk, blas.bvh, blas.tris,
                          with_stats)
        G = len(ks)
        ent, ok = _repass_setup(inst, ks, o, d)
        inv_flat = jnp.stack([inst.inv[k].reshape(12) for k in ks])
        g_iota = jnp.arange(G, dtype=jnp.int32)[:, None]

        def cand_of(occ, walked):
            return ok & ~walked & (ent < tmax[None]) & active[None] \
                & ~occ[None]

        def cond(c):
            return jnp.any(cand_of(c[0], c[1]))

        def body(c):
            occ, walked, steps, leafs = c
            cand = cand_of(occ, walked)
            pend = jnp.any(cand, axis=0)
            pick = jnp.argmin(jnp.where(cand, ent, BIG), axis=0
                              ).astype(jnp.int32)
            walked = walked | ((g_iota == pick[None]) & pend[None])
            o_l, d_l = _repass_local_rays(inv_flat, pick, o, d)
            occ_k = a_k(o_l, d_l, tmax, no_excl, pend)
            if with_stats:
                occ_k, (s2, l2) = occ_k
                steps, leafs = steps + s2, leafs + l2
            return occ | occ_k, walked, steps, leafs

        walked0 = jnp.zeros((G,) + tmax.shape, bool)
        occ, _, steps, leafs = jax.lax.while_loop(
            cond, body, (occ, walked0, steps, leafs))

    if with_stats:
        return occ, (steps, leafs)
    return occ


def trace_closest(scene, cfg, mode, o, d, tmax, active, with_stats=False):
    """Closest hit over base scene + all instances.

    ``mode`` is :func:`resolve_mode`'s walk.  ``o``/``d`` may be ``[N, 3]``
    arrays or component triples (core.v3); the returned ``normal`` matches
    the input convention.  Returns ``(hit, t, prim, src, normal)``;
    ``normal`` is the world-space unnormalized geometric normal of the hit
    triangle (the reference's cross(e1, e2), triangle.cuh:19), straight
    from the walk — no post-hoc triangle gather.  With ``with_stats=True``
    a trailing ``(node_steps, leaf_visits)`` pair is appended (summed over
    the base scene and every instance walk).
    """
    as_v3 = isinstance(o, tuple)
    if not as_v3:
        o = v3.from_array(o)
        d = v3.from_array(d)
    inst = getattr(scene, "instances", None)

    def _ret(hit, t, prim, src, n_w, st=None):
        if not as_v3:
            n_w = v3.to_array(n_w)
        out = (hit, t, prim, src, n_w)
        return out + ((st,) if with_stats else ())

    if inst is not None and _resolve_two_level(cfg) == "repass":
        hit, t, prim, src, n_l, steps, leafs = _repass_closest(
            scene, cfg, mode, o, d, tmax, active, with_stats)
        n_w = n_l
        for k in range(inst.num):
            n_w = v3.where(src == k + 1, _matvec_v3(inst.nrm[k], n_l), n_w)
        return _ret(hit, t, prim, src, n_w,
                    (steps, leafs) if with_stats else None)

    closest, _ = _backend(mode, cfg, scene.walk, scene.bvh, scene.tris,
                          with_stats)
    hit, t, prim, n_w, *st = closest(o, d, tmax, active)
    t = jnp.where(hit, t, tmax)
    src = jnp.zeros_like(prim)
    steps, leafs = st[0] if with_stats else (0, 0)

    if inst is not None:
        for k in range(inst.num):
            blas = scene.blas[inst.mesh_id[k]]
            c_k, _ = _backend(mode, cfg, blas.walk, blas.bvh, blas.tris,
                              with_stats)
            m = active & _instance_mask(inst, k, o, d)
            o_l = _affine_point_v3(inst.inv[k], o)
            d_l = _affine_vector_v3(inst.inv[k], d)  # NOT normalized:
            # preserves the ray parameter, so t compares in world units
            h2, t2, p2, n2, *st2 = c_k(o_l, d_l, t, m)
            if with_stats:
                steps, leafs = steps + st2[0][0], leafs + st2[0][1]
            closer = h2 & (t2 < t)
            # cofactor transform = world cross of transformed edges
            n2_w = _matvec_v3(inst.nrm[k], n2)
            t = jnp.where(closer, t2, t)
            prim = jnp.where(closer, p2, prim)
            src = jnp.where(closer, k + 1, src)
            n_w = v3.where(closer, n2_w, n_w)
            hit = hit | closer
    return _ret(hit, t, prim, src, n_w,
                (steps, leafs) if with_stats else None)


def trace_anyhit(scene, cfg, mode, o, d, tmax, exclude, active,
                 with_stats=False):
    """Occlusion over base scene + all instances.

    ``o``/``d`` may be ``[N, 3]`` arrays or component triples.  ``exclude``
    is a BASE-scene triangle index (shadow-ray light exclusion,
    bvh.cuh:239-248); instanced geometry is never excluded.  With
    ``with_stats=True`` returns ``(occluded, (node_steps, leaf_visits))``.
    """
    if not isinstance(o, tuple):
        o = v3.from_array(o)
        d = v3.from_array(d)
    inst = getattr(scene, "instances", None)
    if inst is not None and \
            _resolve_two_level(cfg, "two_level_anyhit") == "repass":
        return _repass_anyhit(scene, cfg, mode, o, d, tmax, exclude, active,
                              with_stats)

    _, anyhit = _backend(mode, cfg, scene.walk, scene.bvh, scene.tris,
                         with_stats)
    occ = anyhit(o, d, tmax, exclude, active)
    if with_stats:
        occ, (steps, leafs) = occ

    if inst is not None:
        no_excl = jnp.full(o[0].shape[0], -1, jnp.int32)
        for k in range(inst.num):
            blas = scene.blas[inst.mesh_id[k]]
            _, a_k = _backend(mode, cfg, blas.walk, blas.bvh, blas.tris,
                              with_stats)
            m = active & ~occ & _instance_mask(inst, k, o, d)
            o_l = _affine_point_v3(inst.inv[k], o)
            d_l = _affine_vector_v3(inst.inv[k], d)
            occ_k = a_k(o_l, d_l, tmax, no_excl, m)
            if with_stats:
                occ_k, (s2, l2) = occ_k
                steps, leafs = steps + s2, leafs + l2
            occ = occ | occ_k
    if with_stats:
        return occ, (steps, leafs)
    return occ


def _hit_material_index(scene, src, prim):
    runs = getattr(scene, "mat_runs", None)
    if runs is not None:
        # prim->material as a run-compare chain (scene.mat_runs): the map is
        # piecewise-constant over leaf-order prim ids in any real scene, so
        # <= 32 vector compares replace the pool-width [P] gather.
        # prim < 0 (miss lanes) lands in run 0, matching the gather path's
        # clamp; instanced lanes are overridden below either way.
        mat_idx = jnp.full(prim.shape, runs[0][1], jnp.int32)
        for s, m in runs[1:]:
            mat_idx = jnp.where(prim >= s, m, mat_idx)
    else:
        prim_safe = jnp.clip(prim, 0, scene.tris.num - 1)
        mat_idx = scene.prim_material[prim_safe]
    inst = getattr(scene, "instances", None)
    if inst is not None:
        for k in range(inst.num):
            mat_idx = jnp.where(src == k + 1, inst.material[k], mat_idx)
    return mat_idx


def gather_hit_materials(scene, src, prim):
    """Material params for hits: ``(mtype, albedo, ior)``.

    Hit *geometry* (position = o + t*d, normal) comes straight from the
    walk (trace_closest), so the only per-hit table lookup left is one
    [P] material-index gather plus the small-table material select.
    """
    return scene.materials.gather(_hit_material_index(scene, src, prim))


def gather_hit_materials_v3(scene, src, prim):
    """Like :func:`gather_hit_materials`, albedo as a component triple."""
    return scene.materials.gather_v3(_hit_material_index(scene, src, prim))
