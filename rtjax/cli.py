"""Command-line interface.

The reference has no CLI (all parameters are literals in main.cu:159-170);
this exposes the same knobs plus scene/backends selection.

    python -m rtjax render --scene cornell_bunny --width 600 --height 600 \
        --spp 10 --bounces 10 -o image.ppm
    python -m rtjax bench ...
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_render_args(p):
    p.add_argument("--scene", default="cornell_bunny",
                   choices=["cornell_bunny", "cornell_planes",
                            "cornell_bunny_mirror", "cornell_bunny_glass"])
    p.add_argument("--width", type=int, default=600)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--bounces", type=int, default=10)
    p.add_argument("--pool", type=int, default=None,
                   help="wavefront path slots (constant.hpp:8 default 2^20)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--traversal", default="auto",
                   choices=["auto", "native", "xla"],
                   help="BVH walk: native (jax.ffi) or the XLA reference")
    p.add_argument("--sort", action="store_true",
                   help="sort the path state every iteration "
                        "(RenderConfig.sort_rays)")
    p.add_argument("--sharded", action="store_true",
                   help="data-parallel over all visible devices")
    p.add_argument("--reference-parity", action="store_true",
                   help="replicate the CUDA reference's estimator quirks "
                        "(see render/wavefront.py deviations 2-4)")
    p.add_argument("--stats", action="store_true",
                   help="print detailed stats: bounce histogram + "
                        "traversal work counters")
    p.add_argument("--checkpoint", default=None, metavar="FILE.npz",
                   help="render in spp batches with checkpoint/resume")
    p.add_argument("-o", "--output", default="image.ppm")


def _build_scene(name):
    from . import scenes
    if name == "cornell_planes":
        return scenes.cornell_planes()
    mat = "matte"
    if name.endswith("_mirror"):
        mat = "mirror"
    elif name.endswith("_glass"):
        mat = "glass"
    return scenes.cornell_bunny(bunny_material=mat)


def cmd_render(args) -> int:
    import jax
    import numpy as np
    from .config import RenderConfig
    from .render import render_frame, write_ppm
    from .utils.profiler import profiler

    with profiler.phase("Building scene"):
        scene, camera = _build_scene(args.scene)
    cfg = RenderConfig(width=args.width, height=args.height,
                       num_samples=args.spp, max_bounces=args.bounces,
                       num_working_paths=args.pool, traversal=args.traversal,
                       sort_rays=args.sort,
                       reference_parity=args.reference_parity,
                       detailed_stats=args.stats, seed=args.seed)
    key = jax.random.key(args.seed)

    with profiler.phase("Rendering"):
        if args.checkpoint is not None:
            from .render.checkpoint import render_checkpointed
            mesh = None
            if args.sharded:
                from .parallel import make_mesh
                mesh = make_mesh()
            fb = np.asarray(render_checkpointed(scene, camera, cfg,
                                                args.checkpoint, mesh=mesh))
            stats = None
        elif args.sharded:
            from .parallel import render_frame_sharded
            fb, stats = render_frame_sharded(scene, camera, cfg, key)
        else:
            fb, stats = render_frame(scene, camera, cfg, key)
        fb = np.asarray(fb)
    if stats is not None:
        rays = float(np.asarray(stats["rays_traced"]))
        print(f"{int(np.asarray(stats['iterations']))} wavefront iterations, "
              f"{rays:.4g} rays traced")
        if args.stats and "bounce_histogram" in stats:
            hist = np.asarray(stats["bounce_histogram"]).tolist()
            print(f"bounce histogram: {hist}")
            print(f"traversal: {int(np.asarray(stats['node_steps']))} node "
                  f"steps, {int(np.asarray(stats['leaf_visits']))} leaf "
                  f"visits")

    with profiler.phase("Writing image"):
        write_ppm(args.output, fb, args.width, args.height)
    print(f"wrote {args.output}")
    return 0


def cmd_bench(args) -> int:
    """Benchmark a built-in scene: report wall time and Mrays/s."""
    import jax
    import numpy as np
    from .config import RenderConfig
    from .render import render_frame

    scene, camera = _build_scene(args.scene)
    cfg = RenderConfig(width=args.width, height=args.height,
                       num_samples=args.spp, max_bounces=args.bounces,
                       num_working_paths=args.pool, traversal=args.traversal,
                       sort_rays=args.sort, seed=args.seed)
    key = jax.random.key(args.seed)
    t0 = time.time()
    fb, stats = render_frame(scene, camera, cfg, key)
    jax.block_until_ready(fb)
    print(f"compile+first run: {time.time() - t0:.1f}s")
    dt, rays = float("inf"), 0.0
    for rep in range(args.reps):
        t0 = time.time()
        fb, stats = render_frame(scene, camera, cfg, jax.random.key(2 + rep))
        jax.block_until_ready(fb)
        rep_dt = time.time() - t0
        if rep_dt < dt:  # rays must come from the SAME rep as the min time
            dt = rep_dt
            rays = float(np.asarray(stats["rays_traced"]))
    print(f"{args.scene} {cfg.width}x{cfg.height}@{cfg.num_samples}spp: "
          f"{dt:.3f}s, {rays:.4g} rays, {rays / dt / 1e6:.2f} Mrays/s")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtjax")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a built-in scene")
    _add_render_args(pr)
    pb = sub.add_parser("bench", help="benchmark a built-in scene "
                        "(see also benchmarks/run_configs.py)")
    _add_render_args(pb)
    pb.add_argument("--reps", type=int, default=2,
                    help="timed repetitions (min is reported)")
    args = parser.parse_args(argv)
    from .utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "bench":
        return cmd_bench(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
