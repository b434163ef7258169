"""Scene aggregate and host-side scene builder.

Equivalent of the reference's scene.cuh, primitive.cuh, and the
hand-rolled scene assembly in main.cu:39-156.  The reference's
pointer-based ``Primitive{Triangle*, Material*, Light*}`` binding records
(primitive.cuh:4-12) become two int32 index arrays over a single global
triangle index space (the BVH leaf order); null light pointers become
INVALID_INDEX.
"""

from __future__ import annotations

import dataclasses
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import BVH_MAX_DEPTH, INVALID_INDEX
from ..core.geometry import Triangles
from ..accel.bvh import BvhArrays
from ..kernels.native_walk import WalkTables, pack as pack_walk
from .material import MaterialBuilder, MaterialTable
from .light import AREA_LIGHT, POINT_LIGHT, LightTable, make_light_table
from .transform import Transform


@partial(jax.tree_util.register_dataclass,
         data_fields=["tris", "bvh", "walk", "materials", "lights",
                      "prim_material", "prim_light", "env_radiance",
                      "instances", "blas"],
         meta_fields=["num_lights", "mat_runs"])
@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-resident scene: a pytree of dense arrays (scene.cuh:4-8).

    Triangles, prim tables and area-light triangle indices are all in BVH
    leaf (permuted) order, so a leaf's primitives are contiguous and the
    "same triangle" identity tests of the wavefront engine are plain int32
    compares (replacing the reference's pointer identity, render.cuh:321,
    bvh.cuh:243).
    """

    tris: Triangles
    bvh: BvhArrays
    walk: WalkTables          # the same BVH and triangles packed into
                              # 16-byte records for the native walk
    materials: MaterialTable
    lights: LightTable
    prim_material: jax.Array  # [P] int32
    prim_light: jax.Array     # [P] int32 (INVALID_INDEX if not emissive)
    env_radiance: jax.Array   # [3] constant environment radiance (the
                              # reference stubs this: light.cuh:66-68 and
                              # the TODOs at render.cuh:105,243,325)
    instances: object         # InstanceTable for two-level traversal, or None
    blas: tuple               # tuple[MeshBlas] shared bottom-level structures
    num_lights: int           # static
    mat_runs: tuple | None = None  # static: the prim->material map as runs
                              # ((start, mat), ...) over LEAF-ORDER prim ids,
                              # when it has few runs (real scenes assign
                              # materials per mesh, so the permuted map stays
                              # piecewise-constant).  Lets the engine replace
                              # the pool-width [P] material gather with
                              # <= MAT_RUN_LIMIT vector compares — same diet
                              # as the emitter-id compares in
                              # render/wavefront.py.


# prim->material run-compare chain: above this many runs the engine falls
# back to the prim_material[prim] gather (not yet re-derived on the GPU,
# ROADMAP S6)
MAT_RUN_LIMIT = 32


def _material_runs(pm: np.ndarray) -> tuple | None:
    """Compress a leaf-order prim->material index map into ``((start, mat),
    ...)`` runs, or None when it has more than MAT_RUN_LIMIT runs."""
    if len(pm) == 0:
        return None
    starts = np.flatnonzero(np.diff(pm)) + 1
    if len(starts) + 1 > MAT_RUN_LIMIT:
        return None
    return tuple((int(s), int(pm[s])) for s in (0, *starts.tolist()))


class SceneBuilder:
    """Host-side scene assembly with the reference factory API.

    Mirrors main.cu's flow: register materials, add triangles/meshes, add
    lights, then :meth:`build` (which runs the sweep-SAH builder and permutes
    everything into leaf order, like Bvh::Bvh at bvh.cuh:30-219).
    """

    def __init__(self):
        self.materials = MaterialBuilder()
        self._p0: list[np.ndarray] = []
        self._p1: list[np.ndarray] = []
        self._p2: list[np.ndarray] = []
        self._mat: list[np.ndarray] = []
        self._num_tris = 0
        # lights
        self._ltype: list[int] = []
        self._lpos: list[tuple] = []
        self._lemit: list[tuple] = []
        self._ltri: list[int] = []
        self._env = (0.0, 0.0, 0.0)
        # instancing: unique meshes + placements
        self._blas_meshes: list[tuple] = []       # (vertices, faces)
        self._instances: list[tuple] = []         # (mesh_idx, matrix, material)
        self._inst_cache = None                   # BLAS build memo

    # -- materials (delegate to MaterialBuilder, material.cuh:25-44) --------
    def make_matte(self, albedo) -> int:
        return self.materials.make_matte(albedo)

    def make_mirror(self, albedo) -> int:
        return self.materials.make_mirror(albedo)

    def make_glass(self, index_of_refraction: float) -> int:
        return self.materials.make_glass(index_of_refraction)

    # -- geometry -----------------------------------------------------------
    def add_triangles(self, p0, p1, p2, material: int) -> np.ndarray:
        """Add a batch of triangles; returns their global indices."""
        p0 = np.atleast_2d(np.asarray(p0, np.float32))
        p1 = np.atleast_2d(np.asarray(p1, np.float32))
        p2 = np.atleast_2d(np.asarray(p2, np.float32))
        n = len(p0)
        self._p0.append(p0)
        self._p1.append(p1)
        self._p2.append(p2)
        self._mat.append(np.full(n, material, np.int32))
        idx = np.arange(self._num_tris, self._num_tris + n)
        self._num_tris += n
        return idx

    def add_mesh(self, vertices, faces, material: int,
                 transform: Transform | None = None) -> np.ndarray:
        """Add a triangle mesh (vertex positions + [F,3] indices).

        Mirrors main.cu:67-84: optional transform applied on the host, then
        faces expanded to triangles.
        """
        v = np.asarray(vertices, np.float64)
        if transform is not None:
            v = transform.apply(v)
        f = np.asarray(faces, np.int64)
        return self.add_triangles(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], material)

    # -- lights (light.cuh:70-84) -------------------------------------------
    def add_point_light(self, pos, intensity) -> int:
        self._ltype.append(POINT_LIGHT)
        self._lpos.append(tuple(pos))
        self._lemit.append(tuple(intensity))
        self._ltri.append(INVALID_INDEX)
        return len(self._ltype) - 1

    def register_mesh(self, vertices, faces) -> int:
        """Register a unique mesh for instancing; returns its mesh id."""
        self._blas_meshes.append((np.asarray(vertices, np.float64),
                                  np.asarray(faces, np.int64)))
        self._inst_cache = None  # content changed: invalidate the BLAS memo
        return len(self._blas_meshes) - 1

    def add_instance(self, mesh_id: int, material: int,
                     transform: Transform | np.ndarray | None = None) -> int:
        """Place an instance of a registered mesh (two-level BVH).

        Unlike :meth:`add_mesh` (which bakes the transform into world-space
        triangles like main.cu:67-84), instances share one bottom-level BVH;
        memory scales with unique meshes, not placements.
        """
        m = np.eye(4)
        if transform is not None:
            m = transform.matrix if isinstance(transform, Transform) \
                else np.asarray(transform, np.float64)
        # copy: a caller mutating its Transform after add_instance must not
        # retroactively move the placed instance (ADVICE r2 #3)
        self._instances.append((mesh_id, np.array(m, np.float64), material))
        self._inst_cache = None  # content changed: invalidate the BLAS memo
        return len(self._instances) - 1

    def set_environment(self, radiance) -> None:
        """Constant environment radiance added on ray miss (completes the
        reference's unimplemented environment light, render.cuh:105)."""
        self._env = tuple(radiance)

    def add_area_light(self, p0, p1, p2, radiance, material: int) -> int:
        """Add an emissive triangle (main.cu:110-116: geometry + light)."""
        tri_idx = int(self.add_triangles(p0, p1, p2, material)[0])
        self._ltype.append(AREA_LIGHT)
        self._lpos.append((0.0, 0.0, 0.0))
        self._lemit.append(tuple(radiance))
        self._ltri.append(tri_idx)
        return len(self._ltype) - 1

    # -- build ---------------------------------------------------------------
    def build(self, max_depth: int = BVH_MAX_DEPTH,
              max_leaf_size: int | None = 8,
              min_leaf_size: int | None = None,
              builder: str = "auto",
              verbose: bool = False) -> Scene:
        """Assemble the device scene (BVH build + leaf-order permutation).

        ``min_leaf_size`` defaults to ``max_leaf_size`` (the 8-triangle
        leaf rule, not yet re-derived for the GPU walk: ROADMAP S6); pass 1
        for reference-exact splitting.
        """
        from ..accel import build_bvh_best

        if min_leaf_size is None:
            min_leaf_size = max_leaf_size if max_leaf_size else 1

        assert self._num_tris > 0, "scene has no geometry"
        p0 = np.concatenate(self._p0)
        p1 = np.concatenate(self._p1)
        p2 = np.concatenate(self._p2)
        mat_idx = np.concatenate(self._mat)

        # per-triangle bounds + vertex-mean centers (triangle.cuh:11,22-37)
        bmin = np.minimum(np.minimum(p0, p1), p2)
        bmax = np.maximum(np.maximum(p0, p1), p2)
        centers = (p0 + p1 + p2) / 3.0

        res = build_bvh_best(bmin, bmax, centers, max_depth=max_depth,
                             max_leaf_size=max_leaf_size,
                             min_leaf_size=min_leaf_size, which=builder)
        if verbose:
            # same stats the reference prints (bvh.cuh:63-69,203-204)
            from ..utils.log import logger
            lo, hi = bmin.min(0), bmax.max(0)
            logger.info(f"Global bounding box: ({lo[0]:.6g}, {lo[1]:.6g}, "
                        f"{lo[2]:.6g}) ({hi[0]:.6g}, {hi[1]:.6g}, "
                        f"{hi[2]:.6g})")
            logger.info(f"BVH has {res.num_nodes} nodes and "
                        f"{self._num_tris} primitives, with max_depth = "
                        f"{res.max_depth}")

        perm = res.perm
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(len(perm))

        prim_light = np.full(self._num_tris, INVALID_INDEX, np.int32)
        ltri = list(self._ltri)
        for li, ti in enumerate(self._ltri):
            if ti != INVALID_INDEX:
                prim_light[ti] = li
                ltri[li] = int(inv_perm[ti])  # light -> permuted triangle idx

        # host-side twin for build-time consumers (make_light_table and the
        # native walk's records): keeps scene build free of device->host
        # fetches
        _hp0 = p0[perm].astype(np.float32)
        _he1 = (_hp0 - p1[perm]).astype(np.float32)
        _he2 = (p2[perm] - _hp0).astype(np.float32)
        tris_host = types.SimpleNamespace(p0=_hp0, e1=_he1, e2=_he2,
                                          n=np.cross(_he1, _he2))
        tris = _device_tris(tris_host)

        instances, blas = self._build_instances(
            max_depth, max_leaf_size, min_leaf_size, builder)
        return Scene(
            tris=tris,
            bvh=res.to_device(),
            walk=_walk_tables(res, tris_host),
            materials=self.materials.build(),
            lights=make_light_table(self._ltype, self._lpos, self._lemit,
                                    ltri, tris_host),
            prim_material=jnp.asarray(mat_idx[perm]),
            mat_runs=_material_runs(mat_idx[perm]),
            prim_light=jnp.asarray(prim_light[perm]),
            env_radiance=jnp.asarray(self._env, jnp.float32),
            instances=instances,
            blas=blas,
            num_lights=len(self._ltype),
        )

    def _build_instances(self, max_depth, max_leaf_size, min_leaf_size,
                         builder):
        """Build shared BLAS + instance table (memoized per build params)."""
        if not self._instances:
            return None, ()
        # memoized per build params; any add_instance/register_mesh call
        # invalidates (_inst_cache = None), and per-instance content rides
        # in the key so content edits with unchanged counts cannot return
        # stale tables
        content = tuple((mid, m.tobytes(), mat)
                        for mid, m, mat in self._instances)
        cache_key = (max_depth, max_leaf_size, min_leaf_size, builder,
                     len(self._blas_meshes), content)
        cached = getattr(self, "_inst_cache", None)
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        from ..accel import build_bvh_best
        from ..accel.instancing import (InstanceTable, MeshBlas,
                                        instance_world_aabb)

        blas = []
        local_bounds = []
        for verts, faces in self._blas_meshes:
            p0 = verts[faces[:, 0]].astype(np.float32)
            p1 = verts[faces[:, 1]].astype(np.float32)
            p2 = verts[faces[:, 2]].astype(np.float32)
            bmin = np.minimum(np.minimum(p0, p1), p2)
            bmax = np.maximum(np.maximum(p0, p1), p2)
            res = build_bvh_best(bmin, bmax, (p0 + p1 + p2) / 3.0,
                                 max_depth=max_depth,
                                 max_leaf_size=max_leaf_size,
                                 min_leaf_size=min_leaf_size or 1,
                                 which=builder)
            perm = res.perm
            pp0 = p0[perm]
            te1, te2 = pp0 - p1[perm], p2[perm] - pp0
            host = types.SimpleNamespace(p0=pp0, e1=te1, e2=te2,
                                         n=np.cross(te1, te2))
            blas.append(MeshBlas(tris=_device_tris(host), bvh=res.to_device(),
                                 walk=_walk_tables(res, host)))
            local_bounds.append((bmin.min(0), bmax.max(0)))

        n_inst = len(self._instances)
        fwd = np.zeros((n_inst, 3, 4), np.float32)
        inv = np.zeros((n_inst, 3, 4), np.float32)
        nrm = np.zeros((n_inst, 3, 3), np.float32)
        lo = np.zeros((n_inst, 3), np.float32)
        hi = np.zeros((n_inst, 3), np.float32)
        mats = np.zeros(n_inst, np.int32)
        mesh_ids = []
        for i, (mid, m, mat) in enumerate(self._instances):
            mesh_ids.append(mid)
            m64 = np.asarray(m, np.float64)
            fwd[i] = m64[:3, :4]
            inv[i] = np.linalg.inv(m64)[:3, :4]
            # cofactor: maps local cross(e1,e2) to world cross(Me1, Me2)
            m3 = m64[:3, :3]
            nrm[i] = np.linalg.det(m3) * np.linalg.inv(m3).T
            lo[i], hi[i] = instance_world_aabb(*local_bounds[mid], m)
            mats[i] = mat
        table = InstanceTable(fwd=jnp.asarray(fwd), inv=jnp.asarray(inv),
                              nrm=jnp.asarray(nrm),
                              aabb_lo=jnp.asarray(lo), aabb_hi=jnp.asarray(hi),
                              material=jnp.asarray(mats),
                              mesh_id=tuple(mesh_ids))
        self._inst_cache = (cache_key, (table, tuple(blas)))
        return self._inst_cache[1]


def _device_tris(h) -> Triangles:
    """Device triangles from host ones: the XLA walk and the native walk's
    records then hold bit-identical edges and normals."""
    return Triangles(p0=jnp.asarray(h.p0), e1=jnp.asarray(h.e1),
                     e2=jnp.asarray(h.e2), n=jnp.asarray(h.n))


def _walk_tables(res, tris_host) -> WalkTables:
    """Native-walk records of a build and its leaf-order host triangles."""
    bmin, bmax, left_first, num_prims, _ = res.padded_arrays()
    return pack_walk(bmin, bmax, left_first, num_prims, tris_host.p0,
                     tris_host.e1, tris_host.e2, tris_host.n)
