"""Multi-host (multi-process) rendering support.

A multi-host cluster runs one process per host; JAX's distributed runtime
stitches their local devices into one global device list, and the existing
sample-space sharding (rtjax.parallel.sharding) then works unchanged: the
mesh spans all hosts, the scene is replicated, and the single framebuffer
psum crosses hosts like any other collective.  There is nothing
host-aware in the render path itself — by design (SURVEY.md §5: the only
collective is the final all-reduce).

Usage (one call per process, before any backend touch)::

    from rtjax.parallel import init_multihost, make_mesh, render_frame_sharded
    init_multihost(coordinator="host0:8476", num_processes=H, process_id=h)
    mesh = make_mesh()          # global devices across all hosts
    fb, stats = render_frame_sharded(scene, cam, cfg, key, mesh)

Every process returns the SAME fully-reduced framebuffer (replicated
output), so any one host can write the image.
"""

from __future__ import annotations


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join this process to the distributed runtime.

    Thin wrapper over ``jax.distributed.initialize`` so callers need no
    jax-internal imports; must run before any JAX computation.  On CPU
    (tests) the collectives run over TCP — the functional stand-in for a
    pod's DCN.
    """
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def process_info():
    """(process_id, num_processes, local_device_count) after init."""
    import jax
    return (jax.process_index(), jax.process_count(),
            jax.local_device_count())
