"""Render configuration.

The reference has compile-time constants only (/root/reference/constant.hpp
plus literals in main.cu:159-170); this dataclass exposes the same knobs with
the same defaults, per render call.
"""

from __future__ import annotations

import dataclasses

from . import constants


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 600
    height: int = 600
    num_samples: int = 10          # spp (main.cu:169)
    max_bounces: int = 10          # (main.cu:170)
    # pool size: the reference uses a fixed 2^20 (constant.hpp:8).  None
    # (default) adapts to the workload (see pool_size).
    num_working_paths: int | None = None
    rr_start: int = constants.RR_START
    rr_threshold: float = constants.RR_THRESHOLD
    seed: int = constants.RAND_SEED
    stack_size: int = constants.BVH_MAX_DEPTH
    # BVH walk: "native" (one thread per ray through jax.ffi, built for the
    # platform the program runs on: CUDA on the GPU, a host build on the
    # CPU; kernels/native_walk.py), "xla" (the vmapped while-loop walk,
    # kernels/traversal.py, the plain reference), or "auto" (= native).
    # A native walk that cannot be built raises; nothing falls back.
    traversal: str = "auto"
    # on the native walk, a base scene or BLAS with at most this many
    # triangles skips the BVH: an unrolled all-triangles MT loop in plain
    # XLA fuses into the iteration (render/trace.py::_direct_closest).
    # 0 disables.
    direct_max_tris: int = 64
    # keep the path state sorted by (continue?, BVH locality) each
    # iteration: the sort compacts live paths into a prefix, which the
    # windowed shading, the windowed flush and sort_every build on
    # (render/wavefront.py).  False (default) keeps slots in place: on an
    # H100 the variadic sort costs more than everything it saves (demo
    # frame 0.1565 s sorted vs 0.0387 s unsorted; PERF.md).
    sort_rays: bool = False
    # run the sort/gen/flush block only on every k-th iteration: in between,
    # continuing paths keep their (one-iteration-stale) slots and dead
    # slots idle instead of refilling; an occupancy guard (< 3/4 pool
    # live) forces a refill iteration so the frame tail never starves.
    # Only active on the compact sorted bundle (non-parity).
    # 0 = auto: k=2 on trivial-BVH scenes (<= 1024 prims), k=1 elsewhere
    # (inherited, not yet re-derived on the GPU: ROADMAP S6).
    sort_every: int = 0
    # two-level (instanced) traversal strategy: "repass" = multi-pass
    # re-dispatch (each pass, every ray picks its nearest unwalked
    # candidate instance and all rays walk that mesh's BLAS in one call;
    # passes repeat until no candidates remain); "loop" = one masked walk
    # per instance.  "auto" selects per measurement (render/trace.py).
    # Ignored for non-instanced scenes.
    two_level: str = "auto"
    # two-level strategy for the ANY-HIT (shadow/occlusion) channel:
    # "auto" follows two_level, "repass"/"loop" force.
    two_level_anyhit: str = "auto"
    # sort key: "morton" (octant-major origin cell), "morton_pos"
    # (position-major origin cell), "prim" (octant-major origin triangle),
    # "prim_pos" (position-major origin triangle), "normal_pos"
    # (position-major, NORMAL-octant tie-break: the sort runs before the
    # next direction is sampled, and matte bounces scatter around the
    # normal), or "adaptive" (position-major shallow / normal-octant-major
    # deep rays).  The morton_pos default is inherited and not yet
    # re-derived on the GPU (ROADMAP S6).
    sort_key: str = "morton_pos"
    # camera-ray generation order: "blocked" hands regenerated slots sample
    # ids in 16x16-pixel screen blocks, so consecutive fresh camera rays
    # cover compact screen areas instead of full-width scanline bands;
    # "scan" keeps raw pixel-major order.  "auto" picks blocked at
    # spp <= 8.  Image expectation is identical either way — only the
    # sample->slot schedule changes.  (Inherited, not yet re-derived on the
    # GPU: ROADMAP S6.)
    camera_order: str = "auto"
    # upper bound on wavefront iterations (safety net for the while_loop);
    # None derives it from the workload.
    max_iterations: int | None = None
    # prefix-windowed shading: the per-iteration sort packs continuing
    # (shading) lanes into a contiguous prefix, so the mat stage runs as a
    # fori_loop over pool/shade_chunks-wide chunks with a TRACED trip count
    # ceil(num_mat/chunk) — end-of-frame and bounce-tail iterations skip the
    # dead suffix entirely (in-window lanes compute bitwise-identically).
    # 1 disables; requires sort_rays.  "auto" picks 1 when the frame
    # refills the pool >= 16 times and 8 otherwise (inherited, not yet
    # re-derived on the GPU: ROADMAP S6).
    shade_chunks: int | str = "auto"

    @property
    def shade_chunks_effective(self) -> int:
        if self.shade_chunks == "auto":
            return 1 if self.total_camera_rays >= 16 * self.pool_size else 8
        return self.shade_chunks
    # one-sample MIS: reuse the path-continuation BSDF sample for the
    # BSDF-side MIS light channel (the standard single-sample estimator,
    # e.g. PBRT); the channel's "closest hit == picked light triangle"
    # test is answered by the path ray's own closest-hit record, so the
    # second BSDF draw, the direct light MT test, and the CH half of the
    # 2N any-hit call all disappear.  Identical expectation to the
    # default two-sample form (the reference's structure,
    # render.cuh:213-245, minus its target bug); slightly higher variance
    # from the path/MIS sample correlation.  Kept as a standard estimator
    # option.  Incompatible with reference_parity.
    one_sample_mis: bool = False
    # collect extended observability counters (SURVEY.md §5): per-depth
    # bounce histogram plus walk node-step / leaf-visit counters.  Off by
    # default — the histogram scatter and counter plumbing cost time.
    detailed_stats: bool = False
    # replicate the reference's three estimator-visible quirks (all fixed by
    # default, see render/wavefront.py docstring): the int-truncated
    # power_heuristic g_pdf (utility.cuh:53), the Russian-roulette re-roll
    # limbo (render.cuh:117-119,128-136), and the BSDF-MIS shadow ray
    # targeting the surface's own triangle (render.cuh:236).  Used to
    # quantify the fixed estimator's delta vs the CUDA binary's output.
    reference_parity: bool = False

    def __post_init__(self):
        # negative k would silently alias the auto branch (the engine tests
        # sort_every > 0) — reject it up front
        if self.sort_every < 0:
            raise ValueError(
                f"sort_every must be >= 0 (0 = auto), got {self.sort_every}")

    @property
    def pool_size(self) -> int:
        """Effective wavefront pool width.

        Explicit ``num_working_paths`` wins; otherwise the largest power
        of two with at least ~16 pool refills, clamped to [2^17, 2^19]
        (inherited, not yet re-derived on the GPU: ROADMAP S6).
        """
        if self.num_working_paths is not None:
            return self.num_working_paths
        n = 1 << 17
        while n < (1 << 19) and n * 16 < self.total_camera_rays:
            n <<= 1
        return n

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def total_camera_rays(self) -> int:
        n = self.num_pixels * self.num_samples
        # camera-ray ids are int32 on device (wavefront.py cam_id); bigger
        # renders must batch spp via render.checkpoint.render_checkpointed
        assert n < 2**31, (
            f"{n} camera rays overflow int32 ray ids; render in spp batches "
            "with rtjax.render.checkpoint.render_checkpointed")
        return n
