"""Multi-chip rendering: sample-space sharding over a device mesh.

The reference is strictly single-GPU (SURVEY.md §5: no NCCL/MPI, no
multi-device anything); rtjax scales by data parallelism over the *sample
space*: the global camera-ray id range
``[0, W*H*spp)`` (render.cuh:254-259's ``camera_ray_id``) is partitioned into
``num_devices`` contiguous chunks, each chip runs the full wavefront engine
on its chunk against a replicated scene + BVH, and the per-chip framebuffers
are combined with a single ``jax.lax.psum`` — the only collective in
the whole frame, mirroring how the reference's only cross-thread communication
is the atomic framebuffer (SURVEY.md §5 'distributed communication backend').

Because each chip folds its device index into the RNG key, shards draw
independent sample sets and the psum is a plain Monte-Carlo average across
chips: rendering with spp=S on D devices gives each device S/D samples per
pixel.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..render.wavefront import render_frame_linear
from ..scene.camera import Camera
from ..scene.scene import Scene


def make_mesh(devices=None, axis_name: str = "chips") -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    import numpy as np
    return Mesh(np.asarray(devices), (axis_name,))


def render_frame_linear_sharded(scene: Scene, camera: Camera,
                                cfg: RenderConfig, key,
                                mesh: Mesh | None = None,
                                axis_name: str = "chips"):
    """Render one frame data-parallel across the mesh; returns the
    all-reduced LINEAR sample-sum framebuffer (not normalized, no gamma)
    plus stats.  ``cfg.num_samples`` is the TOTAL spp; it must divide evenly
    by the mesh size.  ``cfg.num_working_paths`` is the per-chip pool size.
    """
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    n_dev = mesh.devices.size
    assert cfg.num_samples % n_dev == 0, (
        f"num_samples={cfg.num_samples} must divide by mesh size {n_dev}")
    local = dataclasses.replace(cfg, num_samples=cfg.num_samples // n_dev)

    def shard_fn(scene, camera, key):
        idx = jax.lax.axis_index(axis_name)
        # independent per-chip sample streams
        local_key = jax.random.fold_in(key, idx)
        fb, stats = render_frame_linear(scene, camera, local, local_key)
        # one all-reduce: sum of per-chip sample sums
        fb = jax.lax.psum(fb, axis_name)
        rays = jax.lax.psum(stats["rays_traced"], axis_name)
        # per-chip while_loop trip counts differ; report the slowest chip
        # (a replicated out_spec would return an arbitrary shard's value)
        iters = jax.lax.pmax(stats["iterations"], axis_name)
        per_dev = jax.lax.all_gather(stats["rays_traced"], axis_name)
        return fb, {"iterations": iters, "rays_traced": rays,
                    "rays_per_device": per_dev}

    fn = shard_map(
        partial(shard_fn),
        mesh=mesh,
        in_specs=(P(), P(), P()),   # scene/camera/key replicated
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(scene, camera, key)


def render_frame_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                         key, mesh: Mesh | None = None,
                         axis_name: str = "chips"):
    """Render one frame data-parallel across the mesh.

    Returns the fully-reduced, gamma-corrected framebuffer (replicated) and
    stats; see :func:`render_frame_linear_sharded` for the spp contract.
    """
    fb_sum, stats = render_frame_linear_sharded(scene, camera, cfg, key,
                                                mesh, axis_name)
    # per-chip buffers are linear sample sums; normalize by TOTAL spp and
    # apply the gamma-2 post-process exactly once (render.cuh:330-338)
    fb = jnp.sqrt(fb_sum / cfg.num_samples)
    return fb, stats
