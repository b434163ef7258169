"""Checkpoint / resume for long renders.

The reference has none (SURVEY.md §5): a render runs start-to-finish.  Here
the whole state between sample batches is (linear framebuffer, samples done,
seed), so long renders — e.g. the 1024-spp north-star — run as a sequence of
spp batches with an ``.npz`` checkpoint after each; a killed job resumes from
the last batch.

A checkpoint stores a render fingerprint (image/render params + a scene and
camera content hash) and refuses to resume on mismatch, so a stale file from
a different scene or config cannot silently mix incompatible sample batches
into one framebuffer.

Multi-chip: pass ``mesh`` to render each batch data-parallel over a device
mesh (rtjax.parallel.sharding); the checkpoint format is identical, so a job
can even resume on a different mesh size.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from functools import partial

import jax
import numpy as np

from ..config import RenderConfig
from ..utils.log import logger
from .wavefront import render_frame_linear


def render_fingerprint(scene, camera, cfg: RenderConfig) -> str:
    """Content hash of everything that must match for sample batches to be
    accumulated into one framebuffer: image geometry, path-tracing params,
    and the scene + camera array contents (shape/dtype plus f32 checksums —
    cheap even for million-triangle scenes, and any edit to geometry,
    materials, lights, or the camera perturbs it)."""
    import jax.numpy as jnp

    h = hashlib.sha256()
    h.update(repr((cfg.width, cfg.height, cfg.max_bounces, cfg.seed,
                   cfg.rr_start, cfg.rr_threshold)).encode())
    leaves = jax.tree_util.tree_leaves((scene, camera))
    arrays = [x for x in leaves if hasattr(x, "dtype")]
    for x in arrays:
        h.update(repr((str(x.dtype), tuple(x.shape))).encode())

    def _checksum(x):
        # position-weighted BLOCK sums: a plain sum is permutation- and
        # cancellation-insensitive (ADVICE r2 #4), and one whole-array f32
        # sum additionally ABSORBS small single-element edits once its
        # magnitude dwarfs the f32 ulp (a 1e-3 vertex nudge vanishes in a
        # ~1e13 accumulation).  Per-element pseudo-random weights defeat
        # permutation/cancellation; summing per 4096-element block keeps
        # every accumulation small enough that any one-element edit stays
        # above its block's ulp.  All block sums are hashed.
        v = x.astype(jnp.float32).ravel()
        n = v.shape[0]
        blk = 4096
        pad = (-n) % blk
        v = jnp.pad(v, (0, pad))
        idx = jnp.arange(v.shape[0], dtype=jnp.uint32)
        w = ((idx * jnp.uint32(2654435761)) >> 8).astype(jnp.float32)
        return jnp.sum((v * w).reshape(-1, blk), axis=1)

    if arrays:
        # concatenate: per-array block counts differ (jnp.stack would not)
        sums = jax.jit(
            lambda xs: jnp.concatenate([_checksum(x) for x in xs]))(arrays)
        h.update(np.asarray(sums).tobytes())
    return h.hexdigest()


@partial(jax.jit, static_argnames=("cfg",))
def _render_batch(scene, camera, cfg: RenderConfig, key):
    """One spp batch; module-level so every call reuses its compilation."""
    return render_frame_linear(scene, camera, cfg, key)


def render_checkpointed(scene, camera, cfg: RenderConfig, path: str,
                        batch_spp: int | None = None, verbose: bool = True,
                        mesh=None, save_every: int = 4,
                        return_stats: bool = False):
    """Render ``cfg.num_samples`` spp in batches with checkpointing.

    With ``mesh`` (a ``jax.sharding.Mesh``), each batch is rendered
    data-parallel across the mesh (``batch_spp`` must divide by its size).
    Returns the finished (gamma-corrected) framebuffer ``[H*W, 3]``; with
    ``return_stats``, ``(framebuffer, stats)`` where ``stats`` holds the
    ``rays_traced`` and ``batches`` of the batches this call rendered.

    The framebuffer accumulates ON DEVICE; it is fetched to the host only
    every ``save_every`` batches (and at the end) to write the checkpoint,
    so the device does not wait on a host copy after every batch.  A crash
    loses at most ``save_every`` batches of work.
    """
    import jax.numpy as jnp

    batch_spp = batch_spp or max(1, min(cfg.num_samples, 64))
    assert cfg.num_samples % batch_spp == 0, "batch must divide num_samples"
    n_batches = cfg.num_samples // batch_spp
    batch_cfg = dataclasses.replace(cfg, num_samples=batch_spp)
    fp = render_fingerprint(scene, camera, cfg)

    fb = np.zeros((cfg.num_pixels, 3), np.float32)
    start = 0
    if path and os.path.exists(path):
        ck = np.load(path)
        meta_ok = ("fingerprint" in ck
                   and str(ck["fingerprint"]) == fp
                   and int(ck["batch_spp"]) == batch_spp
                   and ck["fb"].shape == fb.shape)
        if meta_ok:
            fb = ck["fb"]
            start = int(ck["batches_done"])
            if verbose:
                logger.info(f"resuming from {path}: {start}/{n_batches} "
                            "batches")
        elif verbose:
            logger.warning(f"checkpoint {path} does not match this render "
                           "(different scene/camera/config); starting fresh")

    base_key = jax.random.key(cfg.seed)
    if mesh is not None:
        from ..parallel.sharding import render_frame_linear_sharded
        step = lambda key: render_frame_linear_sharded(
            scene, camera, batch_cfg, key, mesh)
    else:
        step = lambda key: _render_batch(scene, camera, batch_cfg, key)
    fb_dev = jnp.asarray(fb)
    total_rays = 0.0
    for b in range(start, n_batches):
        key = jax.random.fold_in(base_key, b)
        fb_b, stats = step(key)
        fb_dev = fb_dev + fb_b  # on-device accumulation, no fetch
        rays = float(np.asarray(stats["rays_traced"]))  # scalar sync only
        total_rays += rays
        if path and ((b + 1) % save_every == 0 or b + 1 == n_batches):
            fb = np.asarray(fb_dev)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, fb=fb, batches_done=b + 1, seed=cfg.seed,
                         batch_spp=batch_spp, fingerprint=fp)
            os.replace(tmp, path)
        if verbose:
            logger.info(f"batch {b + 1}/{n_batches} done ({rays:.3g} rays)")

    image = np.sqrt(np.asarray(fb_dev) / cfg.num_samples)
    if return_stats:
        return image, {"rays_traced": total_rays,
                       "batches": n_batches - start}
    return image
