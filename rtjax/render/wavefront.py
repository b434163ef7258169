"""The wavefront path-tracing engine.

Rebuild of the reference's render.cuh — its core.
The CUDA design is a persistent pool of NUM_WORKING_PATHS slots driven by a
host loop: ``init`` routes slots, CUB compacts pending queues (with two
device->host count copies per bounce), then ``mat``/``gen`` shade and refill,
and ``ah``/``ch`` traverse (SURVEY.md §2.1).

Here the whole frame is ONE ``lax.while_loop`` on device:
- queues + CUB compaction (render.cuh:348-364) are replaced by ONE stable
  multi-payload ``lax.sort`` of the entire path state per iteration
  (sorting.sort_pytree_by_key, ``RenderConfig.sort_rays``): continuing
  paths cluster by BVH locality and dead slots cluster at the back where
  they refill with *consecutive* (coherent) camera rays.  The state lives
  permanently in sorted order — there is no inverse permutation and no
  per-array gathers (the variadic sort moves all payload columns at once);
- hit geometry (t, world geometric normal) comes back FROM the BVH walk,
  so shading needs no triangle-table gathers at all; the hit position is
  ray_o + t*ray_d;
- framebuffer atomics (vec3.cuh:149-153) become deterministic scatter-adds;
- the two host sync points per bounce (render.cuh:433-434,444-445) disappear:
  the loop condition is computed on device;
- every per-lane vector quantity lives as a COMPONENT TRIPLE of ``[N]``
  arrays (core.v3), not ``[N, 3]``: each component is a contiguous array
  the native walk reads directly.

Deliberate behavioral deviations from the reference (all documented against
file:line, none visible statistically):
1. A path that *misses* is regenerated immediately instead of idling until
   its bounce counter exceeds max_bounces (render.cuh:128-136 routes a miss
   to neither queue); radiance is unaffected, slot utilization is better.
2. Russian-roulette termination actually kills the path (standard RR).  The
   reference only drops the slot from the mat queue for one iteration — the
   payload keeps ``hit=true`` (render.cuh:117-119), so a "killed" path is
   re-rolled every following iteration until it survives or exceeds
   max_bounces, a mild upward-bias quirk we do not replicate.
3. The BSDF-sampling MIS shadow ray requires its closest hit to be the
   *picked light's* triangle.  The reference stores the triangle the path is
   standing on instead (render.cuh:236), which silently zeroes nearly the
   whole BSDF-MIS channel; that is a bug, fixed here.
4. ``power_heuristic`` takes float pdfs (utility.cuh:53 truncates one to int).

Deviations 2-4 change the estimator's expectation; ``RenderConfig(
reference_parity=True)`` replicates all three exactly, so the fixed and the
reference estimators can be rendered side by side and their delta published
(BASELINE.md).  Deviation 1 is schedule-only and radiance-neutral either way.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..constants import DEAD_BOUNCES, INVALID_INDEX
from ..core import rng, v3
from ..core.geometry import intersect_triangle_v3, spawn_offset_ray_v3
from ..core.sampling import power_heuristic
from ..core.tables import take_rows
from .trace import (gather_hit_materials_v3, resolve_mode, trace_anyhit,
                    trace_closest)
from ..scene.camera import Camera
from ..scene.light import gather_light_v3, is_delta, pdf_li_v3, sample_li_v3
from ..scene.material import get_f_v3, is_specular, sample_f_v3
from ..scene.scene import Scene
from .sorting import (oct_decode_v3, oct_encode_v3, ray_sort_keys_pos_v3,
                      ray_sort_keys_prim_pos_v3, ray_sort_keys_prim_v3,
                      ray_sort_keys_v3, rgb9e5_decode_v3, rgb9e5_encode_v3,
                      sort_pytree_by_key)

# RNG word ids — ONE threefry sweep of NUM_RNG_WORDS x [N] uint32 per
# iteration (rng.bits_block).  Three diets vs the naive 12-site layout:
# 2-D jitter pairs (light barycentrics, subpixel offset) split one word
# into two 16-bit uniforms (rng.u01_pair); each BSDF block's glass
# reflect/refract draw aliases its matte u1 — a lane is exactly one
# material, so matte lanes consume (u1, u2) and glass lanes consume only
# u3, never both; and EVERY remaining site shares the 16/16 split too —
# 16-bit resolution quantizes sampled directions by ~2^-16, far below
# shot noise (statistical-parity contract, core/rng.py).  12 -> 8 -> 5
# words per iteration; threefry cost is linear in words.
_W_RR_PICK = 0      # 16/16 split -> (RR uniform, light pick)
_W_BSDF1 = 1        # 16/16 split -> (u1, u2); u3 aliases u1
_W_LIGHT_UV = 2     # 16/16 split pair
_W_BSDF2 = 3        # 16/16 split -> (u1, u2); u3 aliases u1
_W_GEN = 4          # 16/16 split pair
NUM_RNG_WORDS = 5


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PathState:
    """SoA path-ray payload (render.cuh:10-18), one entry per pool slot.

    Unlike the reference's ``(u, v, primitive*)`` intersection record, the
    slot carries the hit distance and the world-space geometric normal
    straight from the BVH walk — shading reconstructs the hit point
    as ``ray_o + t*ray_d`` and never touches the triangle tables.

    Vector fields are component triples ``(x, y, z)`` of ``[N]`` arrays
    (see module docstring / core.v3).
    """

    pixel: jax.Array    # [N] int32
    ray_o: tuple        # 3 x [N] float32
    ray_d: tuple        # 3 x [N] float32
    hit: jax.Array      # [N] bool
    t: jax.Array        # [N] float32 hit distance (inf on miss)
    normal: tuple       # 3 x [N] float32 unnormalized geometric normal
                        # (cross(e1, e2) in world space, triangle.cuh:19)
    prim: jax.Array     # [N] int32 (triangle index within src, -1 = none)
    src: jax.Array      # [N] int32 hit source: 0 = base scene, k = instance
    bounces: jax.Array  # [N] int32
    beta: tuple         # 3 x [N] float32 throughput
    acc: tuple          # 3 x [N] float32 radiance accumulated for the slot's
                        # CURRENT pixel; flushed to the framebuffer when the
                        # slot regenerates (one scatter-add per iteration
                        # instead of three, replacing per-contribution
                        # atomics, vec3.cuh:149-153)


def make_initial_state(n: int) -> PathState:
    """Fresh pool: every slot dead so iteration 0 routes all to gen
    (render.cuh:75-82 uses bounces=INT_MAX for the same purpose)."""
    zeros = lambda: jnp.zeros(n, jnp.float32)
    return PathState(
        pixel=jnp.zeros(n, jnp.int32),
        ray_o=(zeros(), zeros(), zeros()),
        ray_d=(zeros(), zeros(), jnp.ones(n, jnp.float32)),
        hit=jnp.zeros(n, bool),
        t=jnp.full(n, jnp.inf, jnp.float32),
        normal=(zeros(), zeros(), zeros()),
        prim=jnp.full(n, INVALID_INDEX, jnp.int32),
        src=jnp.zeros(n, jnp.int32),
        bounces=jnp.full(n, DEAD_BOUNCES, jnp.int32),
        beta=(jnp.ones(n, jnp.float32),) * 3,
        acc=(zeros(), zeros(), zeros()),
    )


import functools


@functools.lru_cache(maxsize=8)
def _blocked_pixel_order(width: int, height: int, block: int = 16):
    """Permutation rank -> pixel index visiting the screen in 16x16 blocks
    (row-major blocks, row-major within; ragged edge blocks included).
    Host numpy, cached per (W, H); becomes a jit constant."""
    import numpy as np
    y, x = np.mgrid[0:height, 0:width]
    nbx = (width + block - 1) // block
    key = (((y // block) * nbx + (x // block)) * (block * block)
           + (y % block) * block + (x % block))
    return np.argsort(key.ravel(), kind="stable").astype(np.int32)


def _compact_bundle_ok(scene, cfg) -> bool:
    """Static gate for the 15-column sort bundle's packed ranges:
    pixel 21 bits, prim+1 23 bits (base scene AND every BLAS), src 8 bits,
    bounces 7 bits with 127 as the dead sentinel."""
    max_prim = scene.tris.num
    for blas in getattr(scene, "blas", ()) or ():
        max_prim = max(max_prim, blas.tris.num)
    inst = getattr(scene, "instances", None)
    num_src = 1 + (inst.num if inst is not None else 0)
    return (cfg.num_pixels <= 1 << 21 and max_prim < (1 << 23) - 1
            and num_src <= 1 << 8 and cfg.max_bounces + 1 < 127)


def _accum(acc, value, mask):
    """Per-slot radiance accumulation (component triples).

    Non-finite contributions are dropped: degenerate samples (e.g. a cosine
    sample that cancels the normal, material.cuh:65, pdf -> 0) produce the
    occasional inf/NaN in any float path tracer; the reference would write
    them into the framebuffer via atomics, we refuse.
    """
    ok = mask & v3.isfinite(value)
    return tuple(a + jnp.where(ok, c, 0.0) for a, c in zip(acc, value))


def wavefront_step(scene: Scene, camera: Camera, cfg: RenderConfig, key,
                   carry):
    """One wavefront iteration == one bounce for all in-flight paths
    (the body of the host loop at render.cuh:428-449)."""
    state, fb, cam_start, it, _, rays_traced, occ_sum, *extra = carry
    n = state.pixel.shape[0]
    num_lights = scene.num_lights
    cam_end = cfg.total_camera_rays

    # BVH walk: "native" (jax.ffi, one thread per ray) or "xla"
    mode = resolve_mode(cfg)
    t_closest = partial(trace_closest, scene, cfg, mode,
                        with_stats=cfg.detailed_stats)
    t_anyhit = partial(trace_anyhit, scene, cfg, mode,
                       with_stats=cfg.detailed_stats)

    # all RNG words of this iteration in one threefry sweep.  Draws are
    # slot-position-indexed; the state sort below re-seats paths between
    # draw sites, which is statistically free (iid uniforms, each consumed
    # once) and keeps the whole iteration a fixed-shape pipeline.
    _words = rng.bits_block(key, it, NUM_RNG_WORDS, n)
    draw_pair = lambda w: rng.u01_pair(_words[w])
    u_rr, u_pick = draw_pair(_W_RR_PICK)

    # ---- init: emission, Russian roulette, routing (render.cuh:84-137) ----
    # "did this bounce-0 path hit an emitter, and which one": the reference
    # reads the hit primitive's light back-pointer (render.cuh:100,
    # primitive.cuh:4-12).  For small light counts the light id comes from
    # comparing the hit prim against the <= 16 emitter triangle ids
    # embedded in the light table instead of a pool-width [P]-table gather.
    # Instanced prims are never emissive (lights live in the base
    # scene); prim ids are BLAS-local for instanced hits, hence src == 0.
    if 0 < num_lights <= 16:
        light_idx = jnp.full_like(state.prim, INVALID_INDEX)
        for l in range(num_lights):
            ltri_l = scene.lights.tri[l]
            light_idx = jnp.where((state.prim == ltri_l) & (ltri_l >= 0)
                                  & (state.src == 0), l, light_idx)
    else:
        prim_safe = jnp.clip(state.prim, 0, scene.tris.num - 1)
        light_idx = jnp.where(state.src == 0, scene.prim_light[prim_safe],
                              INVALID_INDEX)
    emit0 = state.hit & (light_idx >= 0) & (state.bounces == 0)
    emit_li = jnp.maximum(light_idx, 0)
    emit_val = tuple(take_rows(scene.lights.emit[:, k], emit_li)
                     for k in range(3))
    acc = _accum(state.acc, emit_val, emit0)

    # constant environment light on miss (the reference's unimplemented
    # TODO at render.cuh:105): pure BSDF-sampled channel, never sampled by
    # NEE, so no MIS weighting is needed
    env_mask = ~state.hit & (state.bounces <= cfg.max_bounces)
    env = scene.env_radiance
    acc = _accum(acc, v3.mul(state.beta, (env[0], env[1], env[2])), env_mask)

    alive = state.bounces < cfg.max_bounces
    beta = state.beta
    beta_max = v3.vmax(beta)
    rr_cand = alive & state.hit & (state.bounces > cfg.rr_start) & \
        (beta_max < cfg.rr_threshold)
    p_term = jnp.maximum(0.05, 1.0 - beta_max)
    rr_kill = rr_cand & (u_rr < p_term)
    rr_boost = jnp.where(rr_cand & ~rr_kill, 1.0 / (1.0 - p_term), 1.0)
    beta = v3.scale(rr_boost, beta)

    bounces = state.bounces + 1
    mat_mask = alive & state.hit & ~rr_kill
    # reference RR quirk (render.cuh:117-119,128-136): a killed path is
    # routed to NEITHER queue — its payload keeps hit=true, so every later
    # init re-rolls RR (fresh uniform, same p) until it survives (beta then
    # scaled) or its still-incrementing bounce counter exceeds max_bounces.
    # Such "limbo" slots idle: they neither shade, trace, nor regenerate.
    limbo = rr_kill if cfg.reference_parity else jnp.zeros_like(rr_kill)

    # ---- sort: the iteration's ONE compaction step ------------------------
    # Stable variadic sort of the whole pool by (continue?, BVH locality):
    # continuing paths group by tree locality, dead slots sink to the back
    # where gen hands them consecutive camera-sample ids (and the slots past
    # cam_end become contiguous inactive runs).  All three walks share this
    # order — the shadow rays originate at the same hit points.  Replaces
    # render.cuh:348-364's CUB queue compaction.
    #
    # Bundle diet: the sort's cost is linear in payload columns,
    # so the default bundle carries the HIT POINT (what shading actually
    # consumes) instead of (ray_o, t), and packs (bounces, src, mat) into
    # one int32 — 18 columns instead of 21, bit-identical images (same
    # values, computed before instead of after the permutation).  Parity
    # mode keeps the full bundle (limbo lanes must restore t/prim/src).
    state_sorted = cfg.sort_rays
    hp_t = jnp.where(mat_mask, state.t, 0.0)
    hp = v3.add(state.ray_o, v3.scale(hp_t, state.ray_d))

    # sort_every > 1: the sort (and gen/flush, below) run only on every
    # k-th iteration — in between, continuing paths keep their slots (one-
    # iteration-stale locality is still a good grouping) and dead slots
    # idle one iteration instead of refilling.  The occupancy guard
    # forces a gen iteration whenever the live prefix drops below 3/4 pool
    # so the frame tail never starves.  Requires the compact sorted bundle
    # (the windowed-shade/flush prefix arithmetic is only valid right after
    # a sort, so both are gated on do_gen).
    # sort_every == 0 resolves per workload: k=2 on trivial-BVH scenes, k=1
    # where the walk dominates (inherited, not yet re-derived on the GPU:
    # ROADMAP S6).  "effective" geometry counts instanced BLAS triangles
    # too: config4 has 4 base tris but 1.1M instanced ones, so the
    # trivially-small classification must not fire there.
    eff_tris = scene.tris.num
    _inst = getattr(scene, "instances", None)
    if _inst is not None:
        eff_tris += sum(scene.blas[m].tris.num for m in _inst.mesh_id)
    k_req = cfg.sort_every if cfg.sort_every > 0 else (
        2 if eff_tris <= 1024 else 1)
    k_sort = k_req if (state_sorted and not cfg.reference_parity
                       and _compact_bundle_ok(scene, cfg)) else 1
    if k_sort > 1:
        num_mat_pre = jnp.sum(mat_mask).astype(jnp.int32)
        do_gen = ((it % k_sort) == 0) | (num_mat_pre * 4 < n * 3)
    else:
        do_gen = jnp.bool_(True)

    # "dirty" = dead lanes still holding unflushed radiance.  A scatter-add
    # pays per update SLOT regardless of value, and in the frame TAIL
    # (camera rays exhausted) the dead suffix grows toward the whole pool
    # while almost every lane's acc is already flushed — so long-dead lanes
    # would re-scatter zeros for many iterations.  A third
    # sort-key class (live < dirty-dead < clean-dead, keys below) packs
    # the dirty lanes right after the live prefix and the flush scatter
    # windows to [num_mat, num_mat + num_dirty).  fb is bitwise identical
    # (the skipped lanes contributed exact zeros); only the dead lanes'
    # slot order changes, which re-seats iid RNG draws (statistical-parity
    # contract, core/rng.py).
    dirty = ~mat_mask & ((acc[0] != 0.0) | (acc[1] != 0.0) | (acc[2] != 0.0))
    num_dirty = jnp.sum(dirty).astype(jnp.int32)

    def _keys():
        if cfg.sort_key == "prim":
            return ray_sort_keys_prim_v3(
                jnp.where(mat_mask, state.prim, -1), state.ray_d, mat_mask)
        if cfg.sort_key == "prim_pos":
            return ray_sort_keys_prim_pos_v3(
                jnp.where(mat_mask, state.prim, -1), state.ray_d, mat_mask)
        root_lo, root_hi = scene.bvh.bmin[0], scene.bvh.bmax[0]
        from .sorting import (ray_sort_keys_pos10_v3,
                              ray_sort_keys_normal_pos_v3,
                              ray_sort_keys_adaptive_v3)
        if cfg.sort_key == "normal_pos":
            return ray_sort_keys_normal_pos_v3(
                hp, state.normal, root_lo, root_hi, mat_mask)
        if cfg.sort_key == "adaptive":
            return ray_sort_keys_adaptive_v3(
                hp, state.normal, bounces, root_lo, root_hi, mat_mask)
        kf = {"morton_pos": ray_sort_keys_pos_v3,
              "morton_pos10": ray_sort_keys_pos10_v3}.get(
            cfg.sort_key, ray_sort_keys_v3)
        return kf(hp, state.ray_d, root_lo, root_hi, mat_mask)

    def _keys_dirty():
        # live (< 0x7FFFFFFE) < dirty dead (0x7FFFFFFE) < clean dead
        # (0x7FFFFFFF, the key functions' inactive marker)
        return jnp.where(dirty, jnp.int32(0x7FFFFFFE), _keys())

    if state_sorted:
        if cfg.reference_parity:
            keys = _keys()
            bundle = (state.pixel, state.ray_o, state.ray_d, state.t,
                      state.normal, state.prim, state.src, bounces, beta,
                      acc, mat_mask, limbo)
            (pixel, ray_o_p, ray_d_p, t_p, normal, prim, src, bounces, beta,
             acc, mat_mask, limbo) = sort_pytree_by_key(keys, bundle)
            p = v3.add(ray_o_p,
                       v3.scale(jnp.where(mat_mask, t_p, 0.0), ray_d_p))
        elif _compact_bundle_ok(scene, cfg):
            # compact payload bundle (the sort's cost is linear in columns
            # moved).  Five packings vs the 18-column
            # form, bit-lossless except the normal and the two radiance
            # triples:
            #   pbm  = pixel(21) | bounces(7, saturating dead sentinel 127)
            #          | mat(1)   — every dead lane is re-marked DEAD by gen
            #          below, so the DEAD/DEAD+1 distinction never survives
            #          an iteration
            #   sp   = prim+1(23) | src(8) — prim -1 (no hit) packs as 0
            #   onrm = 16+16-bit octahedral normal (sorting.oct_encode_v3,
            #          ~2^-15 rad)
            #   b9/a9 = beta/acc as shared-exponent RGB9E5 (<= 2^-9 relative
            #          per re-encode on the dominant channel — statistical
            #          quantities only, far below shot noise)
            # _compact_bundle_ok gates the static ranges; oversized scenes
            # fall through to the wide bundle below.
            b7 = jnp.minimum(bounces, 127)
            pbm = state.pixel | (b7 << 21) | \
                (mat_mask.astype(jnp.int32) << 28)
            sp = (state.prim + 1) | (state.src << 23)
            onrm = oct_encode_v3(state.normal)
            b9 = rgb9e5_encode_v3(beta)
            a9 = rgb9e5_encode_v3(acc)
            # ray_d rides as one 16+16-bit octahedral column
            # instead of three f32 ones (9 payload columns, was 11).  The
            # decoded direction only ever feeds shading's wo (the next
            # path ray is freshly BSDF-sampled, and hp was computed from
            # the exact d before the sort), so the ~2^-15-rad quantization
            # is statistical-only — same contract as the normal's oct16.
            od = oct_encode_v3(state.ray_d)
            bundle = (hp, b9, a9, pbm, sp, onrm, od)
            if k_sort > 1:
                bundle = jax.lax.cond(
                    do_gen, lambda b: sort_pytree_by_key(_keys_dirty(), b),
                    lambda b: b, bundle)
            else:
                bundle = sort_pytree_by_key(_keys_dirty(), bundle)
            (p, b9, a9, pbm, sp, onrm, od) = bundle
            ray_d_p = oct_decode_v3(od)
            beta = rgb9e5_decode_v3(b9)
            acc = rgb9e5_decode_v3(a9)
            pixel = pbm & 0x1FFFFF
            b_dec = (pbm >> 21) & 0x7F
            bounces = jnp.where(b_dec >= 127, DEAD_BOUNCES, b_dec)
            mat_mask = (pbm >> 28) & 1 != 0
            prim = (sp & 0x7FFFFF) - 1
            src = (sp >> 23) & 0xFF
            normal = oct_decode_v3(onrm)
            ray_o_p, t_p = p, None  # dead-lane ray keep-alives are inert
        else:
            # bounces ∈ [0, max_bounces+1] ∪ {DEAD, DEAD+1}: 15 bits with a
            # saturating dead sentinel (every dead lane is re-marked DEAD by
            # gen below, so the +1 distinction never survives an iteration)
            b_enc = jnp.minimum(bounces, 0x7FFF)
            meta = b_enc | (state.src << 15) | \
                (mat_mask.astype(jnp.int32) << 27)
            bundle = (state.pixel, hp, state.ray_d, state.normal,
                      state.prim, beta, acc, meta)
            (pixel, p, ray_d_p, normal, prim, beta, acc, meta) = \
                sort_pytree_by_key(_keys_dirty(), bundle)
            mat_mask = (meta >> 27) & 1 != 0
            src = (meta >> 15) & 0xFFF
            b_dec = meta & 0x7FFF
            bounces = jnp.where(b_dec >= 0x7FFF, DEAD_BOUNCES, b_dec)
            ray_o_p, t_p = p, None  # dead-lane ray keep-alives are inert
    else:
        pixel, ray_o_p, ray_d_p, t_p, normal, prim, src = (
            state.pixel, state.ray_o, state.ray_d, state.t, state.normal,
            state.prim, state.src)
        p = hp
    gen_mask = ~mat_mask & ~limbo if cfg.reference_parity else ~mat_mask

    # ---- mat: shading (render.cuh:139-248) --------------------------------
    def _shade(src, prim, beta, p, ray_d_p, normal, mat_mask,
               u_bsdf1, u_pick, u_luv, u_bsdf2):
        """The whole mat stage over any slice of sorted state; returns a
        dict pytree so the chunked dispatcher below can window it to the
        live prefix.  ``p`` is the hit point, computed from the ray
        equation o + t*d before the sort (the reference reconstructs it
        barycentrically, triangle.cuh:15; Wächter–Binder offsetting in
        spawn_offset_ray absorbs the equivalent rounding either way)."""
        mtype, albedo, ior = gather_hit_materials_v3(scene, src, prim)
        multiplier = v3.scale(jnp.float32(num_lights), beta)
        n_g = v3.neg(v3.normalize(normal))  # geometric normal (render.cuh:153)
        wo = ray_d_p

        # (1) BSDF-sample the next path ray (render.cuh:158-171)
        f1, wi1, pdf1, n1 = sample_f_v3(mtype, albedo, ior, wo, n_g, *u_bsdf1)
        next_o, next_d, _ = spawn_offset_ray_v3(p, n1, wi1)
        next_beta = v3.mul(beta, v3.scale(v3.dot(wi1, n1) / pdf1, f1))
        # degenerate sample (pdf ~ 0) -> zero throughput; RR kills the path
        nb_ok = v3.isfinite(next_beta)
        next_beta = tuple(jnp.where(nb_ok, c, 0.0) for c in next_beta)
        out = dict(next_o=next_o, next_d=next_d, next_beta=next_beta)
        if num_lights == 0:
            return out

        # uniform light pick (render.cuh:178-180)
        pick = jnp.minimum((u_pick * num_lights).astype(jnp.int32),
                           num_lights - 1)
        lrec = gather_light_v3(scene.lights, pick)
        l_type, _, l_emit, ltri = lrec[0], lrec[1], lrec[2], lrec[3]
        ltp0, lte1, lte2, ltn = lrec[4], lrec[5], lrec[6], lrec[7]
        delta = is_delta(l_type)

        # (2) light-sampling MIS -> AH shadow ray (render.cuh:183-210)
        wi_l, li, light_t, light_pdf, ltri = sample_li_v3(
            scene.lights, pick, p, u_luv[0], u_luv[1], rec=lrec)
        n_l = v3.where(v3.dot(n_g, wi_l) > 0.0, n_g, v3.neg(n_g))
        got_f, f_l, scat_pdf = get_f_v3(mtype, albedo, wo, wi_l, n_l)
        f_lc = v3.scale(v3.dot(wi_l, n_l), f_l)
        # utility.cuh:53 declares power_heuristic(float, int): the second
        # pdf is C-truncated at both call sites (render.cuh:201,229)
        g_l = jnp.trunc(scat_pdf) if cfg.reference_parity else scat_pdf
        w_l = jnp.where(delta, 1.0, power_heuristic(light_pdf, g_l))
        ah_L = v3.mul(multiplier,
                      v3.scale(w_l / light_pdf, v3.mul(f_lc, li)))
        ah_o, ah_d, ah_tmax = spawn_offset_ray_v3(p, n_l, wi_l, light_t)
        ah_mask = mat_mask & got_f

        # (3) BSDF-sampling MIS -> CH shadow ray (render.cuh:213-245).
        # one_sample_mis reuses the path-continuation sample (wi1) — the
        # standard single-sample estimator; identical expectation, and the
        # channel's closest-hit test is then answered by the path ray's
        # own traversal (engine below), costing zero extra rays
        if cfg.one_sample_mis:
            f2, wi2, pdf2, n2 = f1, wi1, pdf1, n1
        else:
            f2, wi2, pdf2, n2 = sample_f_v3(mtype, albedo, ior, wo, n_g,
                                            *u_bsdf2)
        f2c = v3.scale(v3.dot(wi2, n2), f2)
        spec = is_specular(mtype)
        lpdf2 = pdf_li_v3(scene.lights, pick, p, wi2, rec=lrec)
        g_2 = jnp.trunc(lpdf2) if cfg.reference_parity else lpdf2
        w2 = jnp.where(spec, 1.0, power_heuristic(pdf2, g_2))
        chs_mask = mat_mask & ~delta & (spec | (lpdf2 > 0.0))
        chs_L = v3.mul(multiplier, v3.scale(w2 / pdf2, v3.mul(f2c, l_emit)))
        if cfg.one_sample_mis:
            # no separate shadow ray: "closest hit == the target light
            # triangle" is checked against the path ray's hit record
            out.update(ah_o=ah_o, ah_d=ah_d, ah_tmax=ah_tmax, ah_L=ah_L,
                       ah_mask=ah_mask, ltri=ltri, chs_L=chs_L,
                       chs_mask=chs_mask)
            return out
        chs_o, chs_d, _ = spawn_offset_ray_v3(p, n2, wi2)
        # "closest hit == the target triangle" (render.cuh:321)  <=>  the
        # ray hits the target at t AND nothing else hits with t' < t.  One
        # direct MT test + an any-hit query (excluding the target) replaces
        # the expensive closest-hit traversal.
        if cfg.reference_parity:
            # render.cuh:236 stores the triangle the path is STANDING ON as
            # the target, so the channel pays off only in the degenerate
            # case where the bounce ray re-hits its own triangle — the
            # reference bug, replicated bit-for-bit.  (Instanced hits have
            # no base-scene "own" triangle; the reference has no instancing,
            # and the masked-off channel contributes 0 there either way.)
            prim_s2 = jnp.clip(prim, 0, scene.tris.num - 1)
            chs_tgt = jnp.where(src == 0, prim, INVALID_INDEX)
            own_tri = tuple(
                tuple(take_rows(getattr(scene.tris, f)[:, k], prim_s2)
                      for k in range(3))
                for f in ("p0", "e1", "e2", "n"))
            chs_hit_l, chs_t, _, _ = intersect_triangle_v3(
                chs_o, chs_d, jnp.inf, *own_tri)
            chs_mask = chs_mask & chs_hit_l & (src == 0)
        else:
            # target fixed to the picked light (deviation 3); its triangle
            # is embedded in the light table — no scene gather
            chs_tgt = ltri
            chs_hit_l, chs_t, _, _ = intersect_triangle_v3(
                chs_o, chs_d, jnp.inf, ltp0, lte1, lte2, ltn)
            chs_mask = chs_mask & chs_hit_l
        out.update(ah_o=ah_o, ah_d=ah_d, ah_tmax=ah_tmax, ah_L=ah_L,
                   ah_mask=ah_mask, ltri=ltri, chs_o=chs_o, chs_d=chs_d,
                   chs_L=chs_L, chs_mask=chs_mask, chs_tgt=chs_tgt,
                   chs_t=chs_t)
        return out

    b1u1, b1u2 = draw_pair(_W_BSDF1)
    b2u1, b2u2 = draw_pair(_W_BSDF2)
    shade_in = (src, prim, beta, p, ray_d_p, normal, mat_mask,
                (b1u1, b1u2, b1u1),
                u_pick,
                draw_pair(_W_LIGHT_UV),
                (b2u1, b2u2, b2u1))
    C = cfg.shade_chunks_effective
    if state_sorted and C > 1 and n % C == 0:
        # prefix-windowed shading: shade only the chunks overlapping
        # [0, win) where win = last live index + 1.  On sorted iterations
        # win == num_mat (live lanes are exactly the prefix; dirty dead
        # lanes behind it don't shade); on sort_every SKIP iterations the
        # live lanes are a scattered subset of the previous prefix, and
        # the max-index reduction still bounds them exactly.  Beyond-
        # window lanes keep zeros — every consumer below is masked.
        csz = n // C
        lane_idx = jnp.arange(n, dtype=jnp.int32)
        win = jnp.max(jnp.where(mat_mask, lane_idx, -1)) + 1
        nchunks = (win + csz - 1) // csz

        def zeros_out():
            zf = lambda: jnp.zeros(n, jnp.float32)
            z3 = lambda: (zf(), zf(), zf())
            out = dict(next_o=z3(), next_d=z3(), next_beta=z3())
            if num_lights > 0:
                out.update(ah_o=z3(), ah_d=z3(), ah_tmax=zf(), ah_L=z3(),
                           ah_mask=jnp.zeros(n, bool),
                           ltri=jnp.full(n, INVALID_INDEX, jnp.int32),
                           chs_L=z3(), chs_mask=jnp.zeros(n, bool))
                if not cfg.one_sample_mis:
                    out.update(chs_o=z3(), chs_d=z3(), chs_t=zf(),
                               chs_tgt=jnp.full(n, INVALID_INDEX,
                                                jnp.int32))
            return out

        def chunk_body(c, outs):
            sl = jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_slice_in_dim(a, c * csz, csz),
                shade_in)
            return jax.tree_util.tree_map(
                lambda o, x: jax.lax.dynamic_update_slice_in_dim(
                    o, x, c * csz, 0), outs, _shade(*sl))

        sh = jax.lax.fori_loop(0, nchunks, chunk_body, zeros_out())
    else:
        sh = _shade(*shade_in)
    next_o, next_d, next_beta = sh["next_o"], sh["next_d"], sh["next_beta"]
    if num_lights > 0:
        ah_o, ah_d, ah_tmax = sh["ah_o"], sh["ah_d"], sh["ah_tmax"]
        ah_L, ah_mask, ltri = sh["ah_L"], sh["ah_mask"], sh["ltri"]
        chs_L, chs_mask = sh["chs_L"], sh["chs_mask"]
        if not cfg.one_sample_mis:
            chs_o, chs_d = sh["chs_o"], sh["chs_d"]
            chs_tgt, chs_t = sh["chs_tgt"], sh["chs_t"]

    # ---- gen: refill dead slots with camera rays (render.cuh:250-275) -----
    blocked = (cfg.camera_order == "blocked"
               or (cfg.camera_order == "auto" and cfg.num_samples <= 8))
    gen_u, gen_v = draw_pair(_W_GEN)

    def _gen_lanes(idx, num_mat_g):
        """Camera-ray generation over lane indices ``idx`` (post-sort
        positions; dead lanes are the suffix, so rank = idx - num_mat)."""
        gen_rank = jnp.maximum(idx - num_mat_g, 0)
        cam_id = cam_start + gen_rank
        got_ray = (idx >= num_mat_g) & (cam_id < cam_end)
        pix_rank = jnp.minimum(cam_id // cfg.num_samples, cfg.num_pixels - 1)
        if blocked:
            # rank -> pixel through a 16x16-block permutation (host-built
            # constant): consecutive sample ids map to compact screen
            # blocks, so neighbouring fresh camera rays walk one screen
            # region instead of a full-width scanline band
            pix_new = jnp.asarray(_blocked_pixel_order(cfg.width,
                                                       cfg.height))[pix_rank]
        else:
            pix_new = pix_rank  # raw pixel-major sample ids
        ci = (pix_new % cfg.width).astype(jnp.float32)
        cj = (pix_new // cfg.width).astype(jnp.float32)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, idx[0], idx.shape[0]) \
            if idx.shape[0] != n else a
        cam_o, cam_d = camera.get_rays_v3((ci + sl(gen_u)) / cfg.width,
                                          (cj + sl(gen_v)) / cfg.height)
        return got_ray, pix_new, cam_o, cam_d

    def _gen_block(_):
        num_gen = jnp.sum(gen_mask).astype(jnp.int32)
        if state_sorted and not cfg.reference_parity:
            # after the sort the continuing lanes are EXACTLY the prefix
            # (dead lanes all carry the max key), so the exclusive prefix
            # sum over gen_mask is plain arithmetic — drops a full-pool-
            # width cumsum (log-passes) from every iteration.  Parity mode
            # keeps the cumsum: limbo lanes sit interleaved with dead lanes
            # in the suffix.
            num_mat_g = jnp.sum(mat_mask).astype(jnp.int32)
            if n % 8 == 0:
                # suffix-chunked: camera math runs only on the 1/8-chunks
                # overlapping the REFILLABLE window [num_mat, num_mat +
                # remaining-camera-rays) — at high occupancy that is the
                # last chunk or two, and in the frame tail (camera ids
                # exhausted) every chunk skips.  Skipped chunks keep
                # got_ray=False / zeros, which every consumer masks.
                csz = n // 8
                win_end = num_mat_g + jnp.maximum(cam_end - cam_start, 0)

                def zeros():
                    zf = lambda: jnp.zeros(n, jnp.float32)
                    return (jnp.zeros(n, bool), jnp.zeros(n, jnp.int32),
                            (zf(), zf(), zf()), (zf(), zf(), zf()))

                def gen_chunk(c, outs):
                    def do(outs):
                        idx = jnp.arange(csz, dtype=jnp.int32) + c * csz
                        res = _gen_lanes(idx, num_mat_g)
                        upd = lambda o, x: jax.lax.dynamic_update_slice_in_dim(
                            o, x, c * csz, 0)
                        return jax.tree_util.tree_map(upd, outs, res)

                    return jax.lax.cond(((c + 1) * csz > num_mat_g)
                                        & (c * csz < win_end), do,
                                        lambda o: o, outs)

                got_ray, pix_new, cam_o, cam_d = jax.lax.fori_loop(
                    0, 8, gen_chunk, zeros())
                return (got_ray, pix_new, cam_o, cam_d, num_gen)
            idx = jnp.arange(n, dtype=jnp.int32)
            got_ray, pix_new, cam_o, cam_d = _gen_lanes(idx, num_mat_g)
            return (got_ray, pix_new, cam_o, cam_d, num_gen)
        gen_rank = jnp.cumsum(gen_mask) - gen_mask  # excl. prefix sum
        cam_id = cam_start + gen_rank.astype(jnp.int32)
        got_ray = gen_mask & (cam_id < cam_end)
        pix_rank = jnp.minimum(cam_id // cfg.num_samples, cfg.num_pixels - 1)
        if blocked:
            pix_new = jnp.asarray(_blocked_pixel_order(cfg.width,
                                                       cfg.height))[pix_rank]
        else:
            pix_new = pix_rank
        ci = (pix_new % cfg.width).astype(jnp.float32)
        cj = (pix_new // cfg.width).astype(jnp.float32)
        cam_o, cam_d = camera.get_rays_v3((ci + gen_u) / cfg.width,
                                          (cj + gen_v) / cfg.height)
        return (got_ray, pix_new, cam_o, cam_d, num_gen)

    if k_sort > 1:
        # skip iterations refill nothing: dead lanes idle one iteration
        def _no_gen(_):
            zf = lambda: jnp.zeros(n, jnp.float32)
            return (jnp.zeros(n, bool), jnp.zeros(n, jnp.int32),
                    (zf(), zf(), zf()), (zf(), zf(), zf()), jnp.int32(0))

        got_ray, pix_new, cam_o, cam_d, num_gen = jax.lax.cond(
            do_gen, _gen_block, _no_gen, None)
    else:
        got_ray, pix_new, cam_o, cam_d, num_gen = _gen_block(None)

    # flush the radiance accumulators of slots leaving their pixel: ONE
    # deterministic scatter-add per iteration (replaces the reference's
    # three atomic-add channels, render.cuh:102,292,322).  A scatter pays
    # per update SLOT regardless of value, and after the sort every
    # flushing (dead) lane sits in a contiguous SUFFIX of the pool — so
    # scatter only the 1/8-chunks that overlap the dead suffix (full width
    # when unsorted): at high occupancy only the last ~n/8 slots scatter.
    flush = tuple(jnp.where(gen_mask, c, 0.0) for c in acc)
    if state_sorted and n % 8 == 0:
        csz = n // 8
        # on sort_every skip iterations nothing regenerates, so nothing may
        # flush (dead lanes are not a suffix then); num_mat_i = n makes
        # every chunk's overlap test false
        num_mat_i = jnp.where(do_gen, jnp.sum(mat_mask).astype(jnp.int32),
                              jnp.int32(n))
        # window END: with the dirty key class the lanes still holding
        # radiance are exactly [num_mat, num_mat + num_dirty) — chunks past
        # them hold only already-flushed (all-zero) accumulators.  Parity
        # mode keeps the 2-class keys, so its window end stays n.
        flush_end = num_mat_i + num_dirty if not cfg.reference_parity \
            else jnp.int32(n)

        def flush_chunk(c, fb):
            def do(fb):
                vals = jnp.stack(
                    [jax.lax.dynamic_slice_in_dim(fc, c * csz, csz)
                     for fc in flush], axis=-1)
                pix = jax.lax.dynamic_slice_in_dim(pixel, c * csz, csz)
                return fb.at[pix].add(vals, mode="drop")

            return jax.lax.cond(((c + 1) * csz > num_mat_i)
                                & (c * csz < flush_end), do,
                                lambda fb: fb, fb)

        fb = jax.lax.fori_loop(0, 8, flush_chunk, fb)
    else:
        fb = fb.at[pixel].add(jnp.stack(flush, axis=-1), mode="drop")
    acc = tuple(jnp.where(gen_mask & do_gen, 0.0, c) for c in acc)

    # merge mat-continued and regenerated rays into the path-ray pool
    ray_o = v3.where(mat_mask, next_o, v3.where(got_ray, cam_o, ray_o_p))
    ray_d = v3.where(mat_mask, next_d, v3.where(got_ray, cam_d, ray_d_p))
    pixel = jnp.where(got_ray, pix_new, pixel)
    one = (jnp.float32(1.0),) * 3
    beta = v3.where(mat_mask, next_beta, v3.where(got_ray, one, beta))
    beta = tuple(jnp.broadcast_to(c, mat_mask.shape) for c in beta)
    bounces = jnp.where(got_ray, 0, jnp.where(gen_mask, DEAD_BOUNCES, bounces))

    # ---- BVH walks (render.cuh:278-328) ------------------------------------
    trace_mask = mat_mask | got_ray
    inf = jnp.full(n, jnp.inf, jnp.float32)
    hit, ht, hprim, hsrc, hnrm, *tst = t_closest(ray_o, ray_d, inf,
                                                 trace_mask)
    node_steps = leaf_visits = ah_steps = ah_leafs = 0
    if cfg.detailed_stats:
        node_steps, leaf_visits = tst[0]

    traced = jnp.sum(trace_mask, dtype=jnp.float32)
    if num_lights > 0 and cfg.one_sample_mis:
        # one-sample MIS: the CH channel's "closest hit == the picked
        # light's triangle" is read off the path ray's hit record (the
        # path ray IS the BSDF-MIS ray) — only the NEE any-hit walk
        # remains, at N rays instead of 2N.  rays_traced counts only the
        # traversals actually performed.
        occluded = t_anyhit(ah_o, ah_d, ah_tmax, ltri, ah_mask)
        if cfg.detailed_stats:
            occluded, (s1, l1) = occluded
            ah_steps, ah_leafs = s1, l1
        chs_ok = hit & (hsrc == 0) & (hprim == ltri)
        acc = _accum(acc, ah_L, ah_mask & ~occluded)
        acc = _accum(acc, chs_L, chs_mask & chs_ok)
        traced = traced + jnp.sum(ah_mask, dtype=jnp.float32)
    elif num_lights > 0:
        # both shadow channels ride ONE 2N any-hit call (they share the
        # sort order, so each half keeps its locality): half the calls of
        # separate ah/ch walks
        cat = lambda a, b: jnp.concatenate([a, b])
        cat3 = lambda a, b: tuple(jnp.concatenate([x, y])
                                  for x, y in zip(a, b))
        occ2 = t_anyhit(cat3(ah_o, chs_o), cat3(ah_d, chs_d),
                        cat(ah_tmax, chs_t), cat(ltri, chs_tgt),
                        cat(ah_mask, chs_mask))
        if cfg.detailed_stats:
            occ2, (s1, l1) = occ2
            ah_steps, ah_leafs = s1, l1
        occluded, chs_occ = occ2[:n], occ2[n:]
        acc = _accum(acc, ah_L, ah_mask & ~occluded)
        acc = _accum(acc, chs_L, chs_mask & ~chs_occ)
        traced = traced + jnp.sum(ah_mask, dtype=jnp.float32) + \
            jnp.sum(chs_mask, dtype=jnp.float32)

    if cfg.reference_parity:
        # limbo slots did not trace; the walk returned hit=false for them,
        # but their payload must survive for the next re-roll
        hit = hit | limbo
        ht = jnp.where(limbo, t_p, ht)
        hnrm = v3.where(limbo, normal, hnrm)
        hprim = jnp.where(limbo, prim, hprim)
        hsrc = jnp.where(limbo, src, hsrc)

    new_state = PathState(pixel=pixel, ray_o=ray_o, ray_d=ray_d, hit=hit,
                          t=ht, normal=hnrm, prim=hprim, src=hsrc,
                          bounces=bounces, beta=beta, acc=acc)
    work_left = jnp.any(trace_mask)
    if cfg.reference_parity:
        # limbo paths still hold unflushed radiance; keep iterating until
        # every one has died (bounces > max_bounces) and flushed
        work_left = work_left | jnp.any(limbo)
    occupancy = jnp.sum(trace_mask, dtype=jnp.float32) / n
    if cfg.detailed_stats:
        # bounce-depth histogram of traced path rays (depth 0 = camera rays)
        hist, steps_acc, leafs_acc, ah_s_acc, ah_l_acc = extra
        depth = jnp.clip(bounces, 0, cfg.max_bounces)
        hist = hist.at[depth].add(trace_mask.astype(jnp.int32))
        extra = (hist, steps_acc + node_steps, leafs_acc + leaf_visits,
                 ah_s_acc + ah_steps, ah_l_acc + ah_leafs)
    return (new_state, fb, cam_start + num_gen, it + 1, work_left,
            rays_traced + traced, occ_sum + occupancy) + tuple(extra)


def render_frame_linear(scene: Scene, camera: Camera, cfg: RenderConfig, key):
    """Render a frame, returning the LINEAR sample-sum framebuffer.

    The per-pixel values are sums of per-sample radiance (not yet divided by
    spp, no gamma).  Multi-chip rendering psums these linear buffers across
    the mesh before normalizing once (rtjax.parallel.sharding).
    """
    if cfg.one_sample_mis and cfg.reference_parity:
        raise ValueError("one_sample_mis replaces the reference's second "
                         "BSDF draw (render.cuh:213-245); it cannot be "
                         "combined with reference_parity")
    n = cfg.pool_size
    state = make_initial_state(n)
    fb = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    carry = (state, fb, jnp.int32(0), jnp.int32(0), jnp.bool_(False),
             jnp.float32(0), jnp.float32(0))
    if cfg.detailed_stats:
        carry = carry + (jnp.zeros(cfg.max_bounces + 1, jnp.int32),
                         jnp.int32(0), jnp.int32(0), jnp.int32(0),
                         jnp.int32(0))

    def cond(carry):
        cam_start, it, work_left = carry[2], carry[3], carry[4]
        more = work_left | (cam_start < cfg.total_camera_rays)
        if cfg.max_iterations is not None:
            more = more & (it < cfg.max_iterations)
        return more

    step = partial(wavefront_step, scene, camera, cfg, key)
    state, fb, _, it, _, rays, occ, *extra = jax.lax.while_loop(cond, step,
                                                                carry)
    # avg path-slot occupancy per iteration: the compaction-quality metric
    # the reference never had (SURVEY.md §5 observability)
    stats = {"iterations": it, "rays_traced": rays,
             "avg_occupancy": occ / jnp.maximum(it, 1)}
    if cfg.detailed_stats:
        # [max_bounces+1] path rays traced per bounce depth, plus walk
        # work counters (node-pair steps / leaf visits, the same for the
        # native and the XLA walk)
        stats["bounce_histogram"] = extra[0]
        stats["node_steps"] = extra[1] + extra[3]
        stats["leaf_visits"] = extra[2] + extra[4]
        # any-hit (shadow) walk share of the above totals
        stats["anyhit_steps"] = extra[3]
        stats["anyhit_visits"] = extra[4]
    return fb, stats


@partial(jax.jit, static_argnames=("cfg",))
def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig, key):
    """Render a full frame; returns ``(framebuffer [H*W, 3], stats)``.

    The equivalent of ``render()`` at render.cuh:366-457: initializes the
    pool, iterates the wavefront until every camera ray is consumed and every
    path has died (render.cuh:436's termination rule), then applies the
    sqrt(mean) gamma-2 post-process (render.cuh:330-338).
    """
    fb, stats = render_frame_linear(scene, camera, cfg, key)
    fb = jnp.sqrt(fb / cfg.num_samples)  # gamma 2.0 (render.cuh:330-338)
    return fb, stats
