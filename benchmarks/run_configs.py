"""Render the benchmark frames on the current device and time them.

Usage:
    python benchmarks/run_configs.py [--configs demo,headline,1,2,3,4]
        [--variants "" "traversal=xla" "sort_rays=False"] [--reps 2]
        [--quick] [--out results.jsonl]

Each config's scene is built once; each variant (comma-separated
``RenderConfig`` overrides, "" = defaults) is compiled and run once, then
timed ``--reps`` times in alternating order (A B B A ...), so two variants
are compared inside one process on one card.  Prints the card line
(``nvidia-smi``) first and one line per timed frame; ``--out`` also writes
JSON lines.  Frame seconds are host clock around ``block_until_ready``;
Mrays/s counts every walk (path + both shadow channels).

Configs (BASELINE.md): demo = the reference frame (bunny Cornell 600x600 @
10 spp, main.cu:159-174); headline = bunny Cornell 256x256 @ 64 spp;
1 = bunny matte 256x256 @ 16 spp; 2 = Cornell planes NEE 512x512 @ 64 spp;
3 = glass bunny on a mirror floor, 8 bounces, 256x256 @ 16 spp;
4 = 16 instanced bunnies (1.11M triangles, two-level) 256x256 @ 8 spp;
5 = 1920x1080 @ 1024 spp, checkpointed in 16-spp batches.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def parse_variant(text: str) -> dict:
    """``"a=1,b=False,c=xla"`` -> ``{"a": 1, "b": False, "c": "xla"}``."""
    out = {}
    for item in filter(None, text.split(",")):
        k, v = item.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def instanced_scene(n_inst: int):
    """Config 4: instances of the bunny on a floor under an area light."""
    import numpy as np
    from rtjax import Camera, SceneBuilder, Transform
    from rtjax.scene.mesh import load_ply
    from rtjax.scene.transform import rotate, scale, translate
    from rtjax.scenes import BUNNY_PLY
    mesh = load_ply(BUNNY_PLY)
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    brown = b.make_matte((0.62, 0.57, 0.54))
    red = b.make_matte((0.65, 0.05, 0.05))
    b.add_triangles([-4, 0, 4], [4, 0, 4], [4, 0, -4], white)
    b.add_triangles([-4, 0, 4], [-4, 0, -4], [4, 0, -4], white)
    b.add_area_light((-1, 3.0, -1), (1, 3.0, -1), (1, 3.0, 1),
                     (40, 40, 40), white)
    mid = b.register_mesh(mesh.vertices, mesh.faces)
    rng = np.random.default_rng(3)
    for i in range(n_inst):
        t = Transform(translate(0.0946899, -0.0329874, -0.0587997))
        t.composite(scale(4.0, 4.0, 4.0))
        t.composite(rotate([0, 1, 0], rng.uniform(0, 6.28)))
        t.composite(translate((i % 4) * 1.6 - 2.4, 0.0,
                              (i // 4) * 1.6 - 2.4))
        b.add_instance(mid, brown if i % 2 else red, t)
    cam = Camera.make((0, 4.5, 7.5), (0, 0.6, 0), (0, 1, 0), 40, 1.0)
    return b.build(), cam


def configs(which, quick):
    """Yield ``(name, scene_fn, RenderConfig kwargs)``."""
    from rtjax.scenes import cornell_bunny, cornell_planes
    q = quick
    table = {
        "demo": (cornell_bunny, dict(width=600, height=600,
                                     num_samples=2 if q else 10)),
        "headline": (cornell_bunny, dict(width=256, height=256,
                                         num_samples=8 if q else 64)),
        "1": (cornell_bunny, dict(width=256, height=256,
                                  num_samples=4 if q else 16)),
        "2": (cornell_planes, dict(width=512, height=512,
                                   num_samples=8 if q else 64)),
        "3": (lambda: cornell_bunny(bunny_material="glass", floor="mirror"),
              dict(width=256, height=256, num_samples=4 if q else 16,
                   max_bounces=8)),
        "4": (lambda: instanced_scene(4 if q else 16),
              dict(width=256, height=256, num_samples=2 if q else 8,
                   max_bounces=5)),
    }
    for name in which:
        fn, kw = table[name]
        yield name, fn, {"max_bounces": 10, **kw}


def time_frame(scene, cam, cfg, key):
    import jax
    import numpy as np
    from rtjax.render import render_frame
    t0 = time.perf_counter()
    fb, stats = render_frame(scene, cam, cfg, key)
    jax.block_until_ready(fb)
    dt = time.perf_counter() - t0
    return dt, float(np.asarray(stats["rays_traced"])), \
        int(np.asarray(stats["iterations"]))


def run_config5(quick, out):
    """Config 5: the 1080p frame at 1024 spp in 16-spp checkpointed batches
    (2.1e9 camera rays exceed one call's int32 ray ids).  One 16-spp batch
    is rendered first and timed as set-up (it compiles the batch program);
    the timed render counts the rays its batches traced."""
    from rtjax import RenderConfig
    from rtjax.render.checkpoint import render_checkpointed
    from rtjax.scenes import cornell_bunny
    scene, cam = cornell_bunny()
    spp = 32 if quick else 1024

    def render(n_spp, path):
        cfg = RenderConfig(width=1920, height=1080, num_samples=n_spp,
                           max_bounces=10)
        t0 = time.perf_counter()
        _, stats = render_checkpointed(scene, cam, cfg, path, batch_spp=16,
                                       save_every=16, verbose=False,
                                       return_stats=True)
        return time.perf_counter() - t0, stats["rays_traced"]

    setup, _ = render(16, None)
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "config5.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    dt, rays = render(spp, ckpt)
    os.remove(ckpt)
    rec = dict(config="5", variant="", spp=spp, seconds=dt, rays=rays,
               mrays=rays / dt / 1e6, compile_first=setup)
    print(f"config5 1920x1080@{spp}spp: set-up (compile + first 16-spp "
          f"batch) {setup:.3f} s; {dt:.3f} s, {rays:.0f} rays, "
          f"{rays / dt / 1e6:.2f} Mrays/s sustained", flush=True)
    out.append(rec)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="demo,headline,1,2,3,4")
    ap.add_argument("--variants", nargs="*", default=[""],
                    help='RenderConfig overrides, e.g. "traversal=xla"')
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="fewer samples per pixel (smoke runs)")
    ap.add_argument("--out", default=None, help="JSON-lines output file")
    args = ap.parse_args()

    import jax
    from rtjax import RenderConfig
    from rtjax.utils.cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"card: {card()}; jax {jax.__version__}: {dev.platform} "
          f"{dev.device_kind} x{len(jax.devices())}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    key = jax.random.key(1)
    results = []
    which = args.configs.split(",")
    if "5" in which:
        which.remove("5")
        run_config5(args.quick, results)
    variants = [(v, parse_variant(v)) for v in args.variants]
    for name, scene_fn, kw in configs(which, args.quick):
        t0 = time.perf_counter()
        scene, cam = scene_fn()
        print(f"config {name}: scene built in {time.perf_counter() - t0:.1f}"
              f" s ({scene.tris.num} base triangles)", flush=True)
        cfgs = {}
        for label, over in variants:
            cfg = RenderConfig(**kw)
            cfgs[label] = dataclasses.replace(cfg, **over)
            dt, rays, it = time_frame(scene, cam, cfgs[label], key)
            print(f"  [{name} {label or 'default'}] compile+first run "
                  f"{dt:.2f} s", flush=True)
            results.append(dict(config=name, variant=label,
                                compile_first=dt))
        order = [lab for lab, _ in variants]
        for rep in range(args.reps):
            for label in (order if rep % 2 == 0 else order[::-1]):
                cfg = cfgs[label]
                dt, rays, it = time_frame(scene, cam, cfg, key)
                rec = dict(config=name, variant=label, width=cfg.width,
                           height=cfg.height, spp=cfg.num_samples,
                           seconds=dt, rays=rays, iterations=it,
                           mrays=rays / dt / 1e6)
                results.append(rec)
                print(f"  [{name} {label or 'default'}] "
                      f"{cfg.width}x{cfg.height}@{cfg.num_samples}spp: "
                      f"{dt:.4f} s, {rays:.0f} rays, {it} iterations, "
                      f"{rays / dt / 1e6:.2f} Mrays/s", flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps({**r, "device": dev.device_kind,
                                    "card": card()}) + "\n")


if __name__ == "__main__":
    main()
