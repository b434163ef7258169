"""Compile-time anatomy for the render_frame program.

Splits the set-up cost of a frame into its parts so regressions are
attributable:

- trace+lower: Python tracing -> StableHLO (host side)
- compile: XLA compilation for the device
- first run: execution of the compiled program

Usage: python benchmarks/compile_bench.py [--cold] [--spp 16] [--res 256]
  --cold turns the persistent compilation cache off (a cold compile);
  the default uses it (rtjax.utils.cache).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--pool", type=int, default=None)
    args = ap.parse_args()

    import jax
    from rtjax.utils.cache import disable_compile_cache, enable_compile_cache
    if args.cold:
        disable_compile_cache()
        print("compilation cache: off", file=sys.stderr)
    else:
        print(f"compilation cache: {enable_compile_cache()}", file=sys.stderr)

    from rtjax import RenderConfig
    from rtjax.render.wavefront import render_frame
    from rtjax.scenes import cornell_bunny

    t0 = time.time()
    scene, camera = cornell_bunny()
    print(f"scene build: {time.time() - t0:.1f}s")

    cfg = RenderConfig(width=args.res, height=args.res,
                       num_samples=args.spp, max_bounces=10,
                       num_working_paths=args.pool)
    key = jax.random.key(1)

    t0 = time.time()
    lowered = render_frame.lower(scene, camera, cfg, key)
    t_lower = time.time() - t0
    print(f"trace+lower: {t_lower:.1f}s")

    hlo = lowered.as_text()
    n_custom = hlo.count("rtjax_walk_")
    print(f"StableHLO: {len(hlo) / 1e6:.1f} MB text, "
          f"{n_custom} native walk calls")

    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0
    print(f"compile: {t_compile:.1f}s")

    t0 = time.time()
    fb, stats = compiled(scene, camera, key)
    jax.block_until_ready(fb)
    t_run = time.time() - t0
    print(f"first run: {t_run:.1f}s")
    print(f"TOTAL: {t_lower + t_compile + t_run:.1f}s "
          f"(lower {t_lower:.0f} + compile {t_compile:.0f} + run {t_run:.0f})")


if __name__ == "__main__":
    main()
