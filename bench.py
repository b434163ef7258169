"""Benchmark driver: renders the Stanford-bunny Cornell demo on the
current device and reports throughput in Mrays/s per device.

Prints ONE JSON line: {"metric", "value", "unit", "seconds", "device"}.
The reference itself publishes no numbers (BASELINE.md).

Workload: the reference demo scene (bunny + Cornell walls + 2-tri area
light, main.cu:39-166).  Resolution/spp are chosen per BENCH_* env vars so
the driver can scale; rays counted are every traversal performed (path +
AH shadow + CH shadow), matching the "primary + bounce rays" metric.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> None:
    import jax
    import numpy as np
    from rtjax import RenderConfig
    from rtjax.render.wavefront import render_frame
    from rtjax.scenes import cornell_bunny
    from rtjax.utils.cache import enable_compile_cache
    enable_compile_cache()

    width = int(os.environ.get("BENCH_WIDTH", 256))
    height = int(os.environ.get("BENCH_HEIGHT", 256))
    spp = int(os.environ.get("BENCH_SPP", 64))
    bounces = int(os.environ.get("BENCH_BOUNCES", 10))
    pool_env = os.environ.get("BENCH_POOL")
    pool = int(pool_env) if pool_env else None  # None = workload-adaptive
    traversal = os.environ.get("BENCH_TRAVERSAL", "auto")

    t0 = time.time()
    scene, camera = cornell_bunny()
    build_s = time.time() - t0
    print(f"# scene: {scene.tris.num} tris, {scene.bvh.num_nodes} nodes, "
          f"build {build_s:.1f}s", file=sys.stderr)

    kw = {}
    if os.environ.get("BENCH_SORT") == "1":
        kw["sort_rays"] = True
    if os.environ.get("BENCH_SORT_KEY"):
        kw["sort_key"] = os.environ["BENCH_SORT_KEY"]
    if os.environ.get("BENCH_CAMERA_ORDER"):
        kw["camera_order"] = os.environ["BENCH_CAMERA_ORDER"]
    if os.environ.get("BENCH_SHADE_CHUNKS"):
        kw["shade_chunks"] = int(os.environ["BENCH_SHADE_CHUNKS"])
    if os.environ.get("BENCH_SORT_EVERY"):
        kw["sort_every"] = int(os.environ["BENCH_SORT_EVERY"])
    if os.environ.get("BENCH_ONE_SAMPLE_MIS"):
        # one-sample MIS traces FEWER rays for the same image: wall time
        # drops but Mrays/s also counts fewer traversals — compare the
        # frame seconds, not the headline value
        kw["one_sample_mis"] = bool(int(os.environ["BENCH_ONE_SAMPLE_MIS"]))
    cfg = RenderConfig(width=width, height=height, num_samples=spp,
                       max_bounces=bounces, num_working_paths=pool,
                       traversal=traversal, **kw)
    key = jax.random.key(1)

    # compile
    t0 = time.time()
    fb, stats = render_frame(scene, camera, cfg, key)
    jax.block_until_ready(fb)
    print(f"# compile+first run {time.time() - t0:.1f}s", file=sys.stderr)

    # timed runs (min of 2)
    dt = float("inf")
    for rep in range(2):
        t0 = time.time()
        fb, stats = render_frame(scene, camera, cfg, jax.random.key(2 + rep))
        jax.block_until_ready(fb)
        dt = min(dt, time.time() - t0)
    rays = float(np.asarray(stats["rays_traced"]))
    mrays = rays / dt / 1e6
    print(f"# {width}x{height}@{spp}spp: {dt:.2f}s, {rays:.3g} rays, "
          f"{int(np.asarray(stats['iterations']))} iterations",
          file=sys.stderr)

    out = os.environ.get("BENCH_PPM")
    if out:
        from rtjax.render.film import write_ppm
        write_ppm(out, np.asarray(fb), width, height)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "bunny_cornell_render_throughput",
        "value": round(mrays, 3),
        "unit": "Mrays/s/device",
        "seconds": dt,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
