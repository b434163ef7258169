"""Per-iteration cost of the wavefront step, and what each feature adds.

Times ``render_frame`` at ``max_iterations=1`` and at ``max_iterations=1+R``
and divides the difference by R: the cost of one iteration with the real
pool state and trip counts, the whole frame still one jitted program.
Each ablation changes one engine option, so the differences rank the
iteration's parts on the device it runs on.

Usage: python benchmarks/step_anatomy.py [--scene bunny|planes] [--R 64]
           [--pool-log2 18] [--size 512] [--spp 64]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("bunny", "planes"), default="bunny")
    ap.add_argument("--R", type=int, default=64)
    ap.add_argument("--pool-log2", type=int, default=18)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    args = ap.parse_args()

    import jax
    import numpy as np
    from rtjax import RenderConfig
    from rtjax.render import render_frame
    from rtjax.scenes import cornell_bunny, cornell_planes
    from rtjax.utils.cache import enable_compile_cache
    enable_compile_cache()

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = "no nvidia-smi"
    scene, cam = (cornell_bunny if args.scene == "bunny" else cornell_planes)()
    key = jax.random.key(1)
    R = args.R

    def timed(name, **kw):
        """Median of 5 per-iteration differences, in seconds."""
        base = dict(width=args.size, height=args.size,
                    num_samples=args.spp, max_bounces=10,
                    num_working_paths=1 << args.pool_log2)
        base.update(kw)
        c1 = RenderConfig(max_iterations=1, **base)
        cR = RenderConfig(max_iterations=1 + R, **base)
        for c in (c1, cR):  # compile both programs
            jax.block_until_ready(render_frame(scene, cam, c, key)[0])
        diffs = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(render_frame(scene, cam, c1, key)[0])
            t1 = time.perf_counter()
            fb, st = render_frame(scene, cam, cR, key)
            jax.block_until_ready(fb)
            t2 = time.perf_counter()
            diffs.append(((t2 - t1) - (t1 - t0)) / R)
        med = sorted(diffs)[len(diffs) // 2]
        it = int(np.asarray(st["iterations"]))
        print(f"{name:40s} {med * 1e3:8.4f} ms/iter ({it} iterations run)",
              flush=True)
        return med

    print(f"card: {smi}; {args.scene} scene, {args.size}x{args.size} @ "
          f"{args.spp} spp, pool "
          f"2^{args.pool_log2}, R={R}", flush=True)
    full = timed("default")
    timed("sort_rays=True", sort_rays=True)
    timed("one_sample_mis=True (one any-hit)", one_sample_mis=True)
    timed("camera_order=scan", camera_order="scan")
    timed("max_bounces=0 (camera rays only)", max_bounces=0)
    print(f"default per-iteration: {full * 1e3:.4f} ms "
          f"({(1 << args.pool_log2) / full / 1e6:.1f} M path slots/s)")


if __name__ == "__main__":
    main()
