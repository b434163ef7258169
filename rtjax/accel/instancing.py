"""Two-level BVH: instanced meshes with shared bottom-level structures.

The reference supports placing a mesh only by baking its transform into the
triangles (main.cu:67-84); instancing (BASELINE.md eval config 4: multi-mesh,
>= 1M triangles, two-level BVH) requires sharing one bottom-level BVH (BLAS)
across many placements so memory scales with unique meshes, not instances.

Design — *instance-sequential* traversal instead of a pointer-jumping TLAS
walk: instances are few (tens) and static, so the top level is XLA code
around the single-level walk (render/trace.py): either a static loop over
instances (rays masked by the instance's world AABB, transformed into local
space, traced against the shared BLAS) or the multi-pass re-dispatch, where
each pass every ray walks its nearest unwalked candidate instance; closest
hits merge across instances with running-minimum tmax.

Conventions:
- ray parameter t is preserved by the affine transform because local
  direction is NOT renormalized (d_local = A_inv @ d).
- world-space shading data comes from transforming the stored local edges
  and re-crossing for the normal (exact — no inverse-transpose needed since
  the reference's normal IS cross(e1, e2), triangle.cuh:7).
- instanced primitives cannot be area lights (lights live in the base
  scene), so emissive/identity checks simply require source == 0.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import Triangles
from .bvh import BvhArrays


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshBlas:
    """A unique mesh's bottom-level structures, in LOCAL space."""

    tris: Triangles      # leaf-ordered
    bvh: BvhArrays
    walk: object         # native-walk records (kernels.native_walk)


@partial(jax.tree_util.register_dataclass,
         data_fields=["fwd", "inv", "nrm", "aabb_lo", "aabb_hi", "material"],
         meta_fields=["mesh_id"])
@dataclasses.dataclass(frozen=True)
class InstanceTable:
    """SoA instance records.

    ``fwd``/``inv`` are 3x4 affine rows (rotation|translation) for local->
    world and world->local; ``nrm`` is the cofactor matrix det(M)*M^-T that
    maps a local cross(e1,e2) normal to the world cross(M e1, M e2) —
    preserving the reference's normal convention (triangle.cuh:7,19) without
    gathering and transforming the edges; ``aabb_lo/hi`` are world-space
    instance bounds; ``material`` is the per-instance material id;
    ``mesh_id`` is static (drives which BLAS each instance uses at trace
    time).
    """

    fwd: jax.Array       # [I, 3, 4]
    inv: jax.Array       # [I, 3, 4]
    nrm: jax.Array       # [I, 3, 3] cofactor (normal transform)
    aabb_lo: jax.Array   # [I, 3]
    aabb_hi: jax.Array   # [I, 3]
    material: jax.Array  # [I] int32
    mesh_id: tuple       # static tuple[int], len I

    @property
    def num(self) -> int:
        return len(self.mesh_id)


def affine_rows(matrix: np.ndarray) -> np.ndarray:
    return np.asarray(matrix, np.float32)[:3, :4]


def apply_affine_point(rows, p):
    """rows [3,4] (or [...,3,4]) @ [p,1] for p [..., 3].

    precision="highest" is required: at default precision XLA may lower
    this f32 einsum to reduced-precision matrix passes (TF32 on the GPU),
    which perturbs local-frame rays enough to flip hit triangles near
    silhouettes.
    """
    return jnp.einsum("...ij,...j->...i", rows[..., :3], p,
                      precision="highest") + rows[..., 3]


def apply_affine_vector(rows, v):
    return jnp.einsum("...ij,...j->...i", rows[..., :3], v,
                      precision="highest")


def instance_world_aabb(mesh_bmin, mesh_bmax, matrix) -> tuple:
    """World AABB of a transformed local AABB (8-corner method)."""
    corners = np.array([[mesh_bmin[i] if (k >> i) & 1 == 0 else mesh_bmax[i]
                         for i in range(3)] for k in range(8)])
    w = corners @ np.asarray(matrix)[:3, :3].T + np.asarray(matrix)[:3, 3]
    return w.min(0).astype(np.float32), w.max(0).astype(np.float32)
