"""Materials: SoA table + branchless batched BSDF sampling/evaluation.

Equivalent of the reference's material.cuh.  The reference's
tagged-union struct with per-thread branches becomes a SoA table
(:class:`MaterialTable`) and two batched pure functions (:func:`sample_f`,
:func:`get_f`) that compute every material branch and combine them
with ``jnp.where`` selects — the wavefront analog of SIMT divergence-free
shading.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import INV_PI
from ..core import v3, vec
from ..core.sampling import (same_hemisphere_v3, uniform_sample_sphere_v3)

MATTE = 0
MIRROR = 1
GLASS = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA material parameters (material.cuh:20-22)."""

    mtype: jax.Array   # [M] int32 (MATTE/MIRROR/GLASS)
    albedo: jax.Array  # [M, 3] float32 (matte, mirror)
    ior: jax.Array     # [M] float32 (glass)

    def gather(self, idx):
        """Per-ray material params: ``(mtype, albedo, ior)``.

        Material tables are small, so this is a vector select chain rather
        than an HBM gather (see core.tables).
        """
        from ..core.tables import take_rows
        return (take_rows(self.mtype, idx), take_rows(self.albedo, idx),
                take_rows(self.ior, idx))

    def gather_v3(self, idx):
        """Like :meth:`gather` but albedo as a component triple: select
        chains over ``[N]`` lanes instead of the padded ``[N, 3]`` layout."""
        from ..core.tables import take_rows
        albedo = tuple(take_rows(self.albedo[:, k], idx) for k in range(3))
        return take_rows(self.mtype, idx), albedo, take_rows(self.ior, idx)


class MaterialBuilder:
    """Host-side material registry with the reference factory API
    (material.cuh:25-44)."""

    def __init__(self):
        self._mtype: list[int] = []
        self._albedo: list[tuple] = []
        self._ior: list[float] = []

    def _add(self, mtype, albedo, ior) -> int:
        self._mtype.append(mtype)
        self._albedo.append(albedo)
        self._ior.append(ior)
        return len(self._mtype) - 1

    def make_matte(self, albedo) -> int:
        return self._add(MATTE, tuple(albedo), 1.0)

    def make_mirror(self, albedo) -> int:
        return self._add(MIRROR, tuple(albedo), 1.0)

    def make_glass(self, index_of_refraction: float) -> int:
        return self._add(GLASS, (0.0, 0.0, 0.0), float(index_of_refraction))

    def build(self) -> MaterialTable:
        n = max(len(self._mtype), 1)
        mtype = np.zeros(n, np.int32)
        albedo = np.zeros((n, 3), np.float32)
        ior = np.ones(n, np.float32)
        if self._mtype:
            mtype[:] = self._mtype
            albedo[:] = self._albedo
            ior[:] = self._ior
        return MaterialTable(mtype=jnp.asarray(mtype), albedo=jnp.asarray(albedo),
                             ior=jnp.asarray(ior))


def is_specular(mtype):
    """MIRROR or GLASS (material.cuh:14)."""
    return (mtype == MIRROR) | (mtype == GLASS)


def get_f_v3(mtype, albedo, unit_wo, unit_wi, unit_n):
    """Component-triple form of :func:`get_f` (engine hot path).

    ``albedo``/``unit_wo``/``unit_wi``/``unit_n`` are (x, y, z) triples of
    ``[N]`` arrays (core.v3); same semantics as the array form.
    """
    valid = (mtype == MATTE) & same_hemisphere_v3(unit_wo, unit_wi, unit_n)
    f = v3.scale(INV_PI, albedo)
    pdf = v3.dot(unit_wi, unit_n) * INV_PI
    return valid, f, pdf


def get_f(mtype, albedo, unit_wo, unit_wi, unit_n):
    """BSDF evaluation for light-sampling MIS (material.cuh:47-57).

    Matte only; returns ``(valid, f[...,3], pdf)``.  ``valid`` is False for
    specular materials or when wo/wi are on the same side (the reference's
    ``return false``), in which case f/pdf contents are unspecified.
    """
    valid, f, pdf = get_f_v3(mtype, v3.from_array(albedo),
                             v3.from_array(unit_wo), v3.from_array(unit_wi),
                             v3.from_array(unit_n))
    return valid, v3.to_array(f), pdf


def sample_f_v3(mtype, albedo, ior, unit_wo, unit_n, u1, u2, u3):
    """Component-triple form of :func:`sample_f` (engine hot path).

    Vector args/results are (x, y, z) triples of ``[N]`` arrays; see
    :func:`sample_f` for semantics and reference citations.
    """
    # --- matte / mirror share the flip-to-oppose-wo normal (material.cuh:63)
    n_opp = v3.where(v3.dot(unit_wo, unit_n) > 0.0, v3.neg(unit_n), unit_n)

    # matte: cosine-weighted via normalize(n + uniform_sphere) (material.cuh:64-67)
    wi_matte = v3.normalize(v3.add(n_opp, uniform_sample_sphere_v3(u1, u2)))
    pdf_matte = v3.dot(wi_matte, n_opp) * INV_PI
    f_matte = v3.scale(INV_PI, albedo)

    # mirror (material.cuh:68-72)
    wi_mirror = v3.reflect(unit_wo, n_opp)
    pdf_mirror = jnp.ones_like(pdf_matte)
    f_mirror = v3.scale(1.0 / v3.dot(wi_mirror, n_opp), albedo)

    # glass (material.cuh:73-107)
    cos_theta = v3.dot(unit_wo, unit_n)
    front = cos_theta < 0.0
    cos_theta = jnp.abs(cos_theta)
    inv_cos = 1.0 / cos_theta
    eta_ratio = jnp.where(front, 1.0 / ior, ior)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = eta_ratio * sin_theta > 1.0
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    do_reflect = cannot_refract | (u3 < reflectance)

    n_front = v3.where(front, unit_n, v3.neg(unit_n))  # faces the incomer
    wi_refl = v3.reflect(unit_wo, n_front)
    pdf_refl = jnp.where(cannot_refract, 1.0, reflectance)
    f_refl = jnp.where(cannot_refract, inv_cos, reflectance * inv_cos)

    wi_refr = v3.refract(unit_wo, n_front, eta_ratio, cos_theta)
    pdf_refr = 1.0 - reflectance
    n_refr = v3.neg(n_front)  # flipped to the transmission side (material.cuh:104)
    # NOTE: the reference divides by dot(wi, n) with the ALREADY-FLIPPED
    # normal (material.cuh:104-106), i.e. the *transmitted* cosine.
    f_refr = pdf_refr * eta_ratio * eta_ratio / v3.dot(wi_refr, n_refr)

    wi_glass = v3.where(do_reflect, wi_refl, wi_refr)
    pdf_glass = jnp.where(do_reflect, pdf_refl, pdf_refr)
    f_glass_s = jnp.where(do_reflect, f_refl, f_refr)
    f_glass = (f_glass_s, f_glass_s, f_glass_s)
    n_glass = v3.where(do_reflect, n_front, n_refr)

    # --- combine by material type
    is_matte = mtype == MATTE
    is_mirror = mtype == MIRROR
    wi = v3.where(is_matte, wi_matte, v3.where(is_mirror, wi_mirror, wi_glass))
    f = v3.where(is_matte, f_matte, v3.where(is_mirror, f_mirror, f_glass))
    pdf = jnp.where(is_matte, pdf_matte,
                    jnp.where(is_mirror, pdf_mirror, pdf_glass))
    n_out = v3.where(mtype == GLASS, n_glass, n_opp)
    return f, wi, pdf, n_out


def sample_f(mtype, albedo, ior, unit_wo, unit_n, u1, u2, u3):
    """Branchless batched BSDF sampling (material.cuh:60-108).

    Args:
      mtype/albedo/ior: per-ray gathered material params.
      unit_wo: incoming ray direction (points INTO the surface).
      unit_n: geometric unit normal.
      u1, u2: uniforms for the matte cosine sample.
      u3: uniform for the glass reflect/refract choice.

    Returns ``(f[...,3], unit_wi, pdf, n_out)`` where ``n_out`` is the
    possibly-flipped shading normal the reference writes back by reference
    (used for the offset-ray spawn and the beta cosine).
    """
    f, wi, pdf, n_out = sample_f_v3(
        mtype, v3.from_array(albedo), ior, v3.from_array(unit_wo),
        v3.from_array(unit_n), u1, u2, u3)
    return v3.to_array(f), v3.to_array(wi), pdf, v3.to_array(n_out)
