"""Lights: SoA table + batched NEE sampling and pdf evaluation.

Equivalent of the reference's light.cuh.  The tagged-union struct
with a device triangle pointer becomes a SoA table whose area lights reference
scene triangles by (BVH-permuted) index; ``sample_Li`` / ``pdf_Li`` are
batched masked-select functions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import INVALID_INDEX
from ..core import v3, vec
from ..core.geometry import (Triangles, intersect_triangle,
                             intersect_triangle_v3)
from ..core.sampling import sample_triangle_barycentric
from ..core.tables import take_rows

POINT_LIGHT = 0
AREA_LIGHT = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LightTable:
    """SoA light parameters (light.cuh:20-26).

    ``emit`` holds I (point: radiant intensity) or L (area: radiance), the
    two union members.  ``tri`` is the global triangle index of an area
    light's emitter (INVALID_INDEX for point lights).  The emitter
    triangle's fields (``tri_p0/e1/e2/n``) are embedded per light so NEE
    never gathers from the full scene triangle tables (a select over this
    small table replaces a pool-wide gather).
    """

    ltype: jax.Array   # [L] int32
    pos: jax.Array     # [L, 3] float32 (point)
    emit: jax.Array    # [L, 3] float32 (I or L)
    tri: jax.Array     # [L] int32 (area)
    tri_p0: jax.Array  # [L, 3] emitter triangle (edge-precomputed storage,
    tri_e1: jax.Array  # [L, 3]  triangle.cuh:6-7; zero for point lights)
    tri_e2: jax.Array  # [L, 3]
    tri_n: jax.Array   # [L, 3]

    @property
    def num(self) -> int:
        return self.ltype.shape[0]


def make_light_table(ltype, pos, emit, tri, tris: Triangles | None = None
                     ) -> LightTable:
    """Build the device table; ``tris`` (leaf-ordered scene triangles)
    supplies the embedded emitter-triangle fields for area lights."""
    n = max(len(ltype), 1)
    a_type = np.zeros(n, np.int32)
    a_pos = np.zeros((n, 3), np.float32)
    a_emit = np.zeros((n, 3), np.float32)
    a_tri = np.full(n, INVALID_INDEX, np.int32)
    t_p0 = np.zeros((n, 3), np.float32)
    t_e1 = np.zeros((n, 3), np.float32)
    t_e2 = np.zeros((n, 3), np.float32)
    t_n = np.zeros((n, 3), np.float32)
    if len(ltype):
        a_type[:len(ltype)] = ltype
        a_pos[:len(ltype)] = pos
        a_emit[:len(ltype)] = emit
        a_tri[:len(ltype)] = tri
    if tris is not None:
        p0 = np.asarray(tris.p0)
        e1 = np.asarray(tris.e1)
        e2 = np.asarray(tris.e2)
        nv = np.asarray(tris.n)
        for l, ti in enumerate(a_tri[:len(ltype)] if len(ltype) else []):
            if ti != INVALID_INDEX:
                t_p0[l], t_e1[l], t_e2[l], t_n[l] = \
                    p0[ti], e1[ti], e2[ti], nv[ti]
    return LightTable(ltype=jnp.asarray(a_type), pos=jnp.asarray(a_pos),
                      emit=jnp.asarray(a_emit), tri=jnp.asarray(a_tri),
                      tri_p0=jnp.asarray(t_p0), tri_e1=jnp.asarray(t_e1),
                      tri_e2=jnp.asarray(t_e2), tri_n=jnp.asarray(t_n))


def is_delta(ltype):
    """Point lights are delta lights (light.cuh:15)."""
    return ltype == POINT_LIGHT


def gather_light(lights: LightTable, pick):
    """Per-ray light record via select chains (no HBM gathers)."""
    return tuple(take_rows(t, pick) for t in
                 (lights.ltype, lights.pos, lights.emit, lights.tri,
                  lights.tri_p0, lights.tri_e1, lights.tri_e2, lights.tri_n))


def _rows_v3(table, pick):
    """[L, 3] table -> per-ray component triple via [N]-lane select chains."""
    return tuple(take_rows(table[:, k], pick) for k in range(3))


def gather_light_v3(lights: LightTable, pick):
    """Component-triple form of :func:`gather_light` (engine hot path).

    Up to :data:`~rtjax.core.tables.SELECT_LIMIT` lights this is 20 vector
    select chains (no gathers).  Beyond that the chains grow with L, so
    the many-light path packs the whole record into ONE ``[L, 20]`` row
    matrix and pays a single row gather (flat in L) instead of 20
    per-column gathers.  ``tri`` indices survive the f32 round-trip exactly
    below 2^24 triangles — far above the single-BLAS ceiling.
    """
    from ..core.tables import SELECT_LIMIT
    if lights.num <= SELECT_LIMIT:
        return (take_rows(lights.ltype, pick),
                _rows_v3(lights.pos, pick),
                _rows_v3(lights.emit, pick),
                take_rows(lights.tri, pick),
                _rows_v3(lights.tri_p0, pick),
                _rows_v3(lights.tri_e1, pick),
                _rows_v3(lights.tri_e2, pick),
                _rows_v3(lights.tri_n, pick))
    packed = jnp.concatenate(
        [lights.ltype[:, None].astype(jnp.float32),
         lights.tri[:, None].astype(jnp.float32),
         lights.pos, lights.emit, lights.tri_p0, lights.tri_e1,
         lights.tri_e2, lights.tri_n], axis=1)         # [L, 20] jit constant
    rows = packed[jnp.clip(pick, 0, lights.num - 1)]   # ONE [N, 20] gather
    col = lambda k: rows[:, k]
    trip = lambda k: (col(k), col(k + 1), col(k + 2))
    return (col(0).astype(jnp.int32), trip(2), trip(5),
            col(1).astype(jnp.int32), trip(8), trip(11), trip(14), trip(17))


def sample_li_v3(lights: LightTable, pick, isect_p, u1, u2, rec=None):
    """Component-triple form of :func:`sample_li` (engine hot path).

    ``rec`` optionally passes a pre-gathered :func:`gather_light_v3` record
    so the engine gathers the light row once per iteration.
    """
    ltype, pos, emit, ltri, tp0, te1, te2, tn = \
        rec if rec is not None else gather_light_v3(lights, pick)

    # point light (light.cuh:31-37)
    to_l = v3.sub(pos, isect_p)
    t_pt = v3.length(to_l)
    wi_pt = v3.scale(1.0 / t_pt, to_l)
    li_pt = v3.scale(1.0 / (t_pt * t_pt), emit)
    pdf_pt = jnp.ones_like(t_pt)

    # area light (light.cuh:38-47); p(u,v) = p0 - u*e1 + v*e2
    su, sv = sample_triangle_barycentric(u1, u2)
    tri_p = v3.add(v3.sub(tp0, v3.scale(su, te1)), v3.scale(sv, te2))
    n_len = v3.length(tn)
    pdf_area = 1.0 / (0.5 * n_len)  # 1/area (triangle.cuh:78-79)
    to_a = v3.sub(tri_p, isect_p)
    dist_sq = v3.length_squared(to_a)
    t_ar = jnp.sqrt(dist_sq)
    wi_ar = v3.scale(1.0 / t_ar, to_a)
    # area->solid-angle pdf conversion with |cos| (double-sided emitter)
    pdf_ar = pdf_area * dist_sq * n_len / v3.abs_dot(tn, wi_ar)

    is_pt = ltype == POINT_LIGHT
    unit_wi = v3.where(is_pt, wi_pt, wi_ar)
    li = v3.where(is_pt, li_pt, emit)
    t = jnp.where(is_pt, t_pt, t_ar)
    pdf = jnp.where(is_pt, pdf_pt, pdf_ar)
    return unit_wi, li, t, pdf, ltri


def sample_li(lights: LightTable, pick, isect_p, u1, u2):
    """Batched ``Light::sample_Li`` (light.cuh:29-48).

    Args:
      pick: per-ray picked light index ``[N] int32``.
      isect_p: shading points ``[N, 3]``.
      u1, u2: uniforms for the area-light triangle sample.

    Returns ``(unit_wi, Li, t, pdf, ltri)`` where ``ltri`` is the area
    light's triangle index (INVALID_INDEX for point lights).  The reference
    always returns true for both light types, so there is no valid mask.
    """
    unit_wi, li, t, pdf, ltri = sample_li_v3(
        lights, pick, v3.from_array(isect_p), u1, u2)
    return v3.to_array(unit_wi), v3.to_array(li), t, pdf, ltri


def pdf_li_v3(lights: LightTable, pick, isect_p, unit_wi, rec=None):
    """Component-triple form of :func:`pdf_li` (engine hot path)."""
    ltype, _, _, _, tp0, te1, te2, tn = \
        rec if rec is not None else gather_light_v3(lights, pick)
    hit, _, hu, hv = intersect_triangle_v3(
        isect_p, unit_wi, jnp.inf, tp0, te1, te2, tn)
    lp = v3.add(v3.sub(tp0, v3.scale(hu, te1)), v3.scale(hv, te2))
    n_len = v3.length(tn)
    area = 0.5 * n_len
    pdf = v3.length_squared(v3.sub(lp, isect_p)) * n_len / (
        area * v3.abs_dot(tn, unit_wi))
    valid = (ltype == AREA_LIGHT) & hit
    return jnp.where(valid, pdf, 0.0)


def pdf_li(lights: LightTable, pick, isect_p, unit_wi):
    """Batched ``Light::pdf_Li`` for BSDF-sampling MIS (light.cuh:50-64).

    Intersects the area light's triangle with the (infinite-tmax) ray from
    ``isect_p`` along ``unit_wi``; returns 0 for point lights and misses.
    """
    return pdf_li_v3(lights, pick, v3.from_array(isect_p),
                     v3.from_array(unit_wi))
