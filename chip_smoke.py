#!/usr/bin/env python3
"""Smoke test of rtjax on an NVIDIA GPU: the main path once, end to end.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded frame only

One process runs every phase (a JAX process reserves most of the card's
memory).  Any failure raises and exits non-zero; a platform other than
``gpu`` fails at once.  Phases:

1. the card (``nvidia-smi``), ``jax.devices()`` and the XLA flags;
2. build or load the native BVH walk (CUDA, ``sm_90a``) and its seconds;
3. the native walk against the XLA walk on 2^18 rays of the demo scene
   (camera rays plus cosine-sampled bounce rays and shadow rays from their
   hits): hit and prim agree on >= 99.99% of rays, ``|dt| <= 1e-5 t``
   where both hit the same triangle, occlusion agrees on >= 99.99%;
4. the reference demo frame (bunny Cornell, 600x600 @ 10 spp, 10 bounces,
   main.cu:159-174) through ``render_frame`` with the native walk and with
   ``traversal="xla"``: times, rays, and the two images compared (frame
   mean radiance within 1% per channel, 16x16-pixel block means within 3%
   RMS relative, and 75x75-pixel block means no further apart than the
   native walk from itself with other samples, the noise floor); the
   native image is written as PPM and its header read;
5. the 256x256 @ 64 spp headline frame with the native walk.

``--four`` runs ``render_frame_linear_sharded`` over a 4-card mesh on the
demo frame at 12 spp and compares it with the four shards rendered one
after another on one card (rtol 1e-5).

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def say(*a):
    print(*a, flush=True)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: platform is {devs[0].platform!r}, "
                         "not gpu")
    for line in smi.splitlines():
        say(line)
    say(f"jax {jax.__version__} devices: {devs}")
    say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    from rtjax.utils.cache import enable_compile_cache
    say(f"compile cache: {enable_compile_cache()}")
    return devs


def phase_build():
    from rtjax.kernels import native_walk
    info = native_walk.ensure_registered("gpu")
    say(f"native walk: {info['path']} built in "
        f"{info['build_seconds']:.1f} s")


def _parity_rays(scene, camera, n_cam, seed=0):
    """Camera rays of the demo frame, cosine-sampled bounce rays from their
    hits, and shadow rays from all hits toward the area lights."""
    import jax.numpy as jnp
    import numpy as np
    from rtjax.kernels.traversal import traverse_closest
    rng = np.random.default_rng(seed)
    pix = rng.choice(600 * 600, n_cam, replace=False)
    u = (pix % 600 + rng.random(n_cam)) / 600
    v = (pix // 600 + rng.random(n_cam)) / 600
    o_c, d_c = camera.get_rays(jnp.asarray(u, jnp.float32),
                               jnp.asarray(v, jnp.float32))
    o_c, d_c = np.asarray(o_c), np.asarray(d_c)
    stack = max(30, scene.bvh.max_depth + 1)
    ref = traverse_closest(scene.bvh, scene.tris, jnp.asarray(o_c),
                           jnp.asarray(d_c), jnp.full(n_cam, jnp.inf),
                           jnp.ones(n_cam, bool), stack_size=stack)
    hit, t = np.asarray(ref[0]), np.asarray(ref[1])
    nrm = np.asarray(ref[5])
    n_u = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    n_u = np.where((n_u * d_c).sum(1, keepdims=True) > 0, -n_u, n_u)
    n_u = np.where(hit[:, None], n_u, [[0.0, 1.0, 0.0]])  # misses: unused
    p = o_c + np.where(hit, t, 0.0)[:, None] * d_c
    p_off = p + 1e-4 * n_u
    # cosine-weighted hemisphere about the facing normal
    r1, r2 = rng.random(n_cam), rng.random(n_cam)
    phi = 2 * np.pi * r1
    local = np.stack([np.cos(phi) * np.sqrt(r2), np.sin(phi) * np.sqrt(r2),
                      np.sqrt(1 - r2)], 1)
    a = np.where(np.abs(n_u[:, :1]) > 0.9, [[0.0, 1.0, 0.0]],
                 [[1.0, 0.0, 0.0]])
    tx = np.cross(a, n_u)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(n_u, tx)
    d_b = local[:, :1] * tx + local[:, 1:2] * ty + local[:, 2:] * n_u
    o = np.concatenate([o_c, p_off]).astype(np.float32)
    d = np.concatenate([d_c, d_b]).astype(np.float32)
    active = np.concatenate([np.ones(n_cam, bool), hit])
    # shadow rays: every hit point toward a point on a random area light,
    # excluding that light's triangle (the engine's NEE any-hit query), and
    # the bounce rays again as occlusion queries with finite or open tmax
    lt = np.asarray(scene.lights.tri)
    area = lt[lt >= 0]
    pick = area[rng.integers(0, len(area), n_cam)]
    p0 = np.asarray(scene.tris.p0)[pick]
    e1 = np.asarray(scene.tris.e1)[pick]
    e2 = np.asarray(scene.tris.e2)[pick]
    su = np.sqrt(rng.random(n_cam))
    b1, b2 = (1 - su), rng.random(n_cam) * su
    q = p0 - b1[:, None] * e1 + b2[:, None] * e2
    to = q - p_off
    dist = np.linalg.norm(to, axis=1)
    s_d = to / dist[:, None]
    s_o = np.concatenate([p_off, p_off]).astype(np.float32)
    s_dir = np.concatenate([s_d, d_b]).astype(np.float32)
    s_tmax = np.concatenate([dist * (1 - 1e-4),
                             np.where(rng.random(n_cam) < 0.5,
                                      rng.uniform(0.05, 1.0, n_cam), np.inf)])
    s_ex = np.concatenate([pick, np.full(n_cam, -1)]).astype(np.int32)
    s_act = np.concatenate([hit, hit])
    return (o, d, active), (s_o, s_dir, s_tmax.astype(np.float32), s_ex,
                            s_act), stack


def phase_parity(scene, camera, n=1 << 18):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rtjax.kernels import native_walk
    from rtjax.kernels.traversal import traverse_anyhit, traverse_closest
    (o, d, act), (so, sd, stm, sex, sact), stack = _parity_rays(
        scene, camera, n // 2)
    J = jnp.asarray
    inf = jnp.full(n, jnp.inf)
    closest = {
        "xla": jax.jit(lambda o, d, a: traverse_closest(
            scene.bvh, scene.tris, o, d, inf, a, stack_size=stack)),
        "native": jax.jit(lambda o, d, a: native_walk.closest(
            scene.walk, tuple(o.T), tuple(d.T), inf, a, stack_size=stack)),
    }
    anyhit = {
        "xla": jax.jit(lambda o, d, tm, e, a: traverse_anyhit(
            scene.bvh, scene.tris, o, d, tm, e, a, stack_size=stack)),
        "native": jax.jit(lambda o, d, tm, e, a: native_walk.anyhit(
            scene.walk, tuple(o.T), tuple(d.T), tm, e, a, stack_size=stack)),
    }
    args_c = (J(o), J(d), J(act))
    args_a = (J(so), J(sd), J(stm), J(sex), J(sact))
    ref = closest["xla"](*args_c)
    got = closest["native"](*args_c)
    rh, rt, rp = (np.asarray(ref[0]), np.asarray(ref[1]),
                  np.asarray(ref[4]))
    gh, gt, gp = (np.asarray(got[0]), np.asarray(got[1]),
                  np.asarray(got[2]))
    agree = (rh == gh) & (rp == gp)
    same = rh & gh & (rp == gp)
    dt_bad = same & (np.abs(np.where(same, gt - rt, 0.0)) > 1e-5 * rt)
    occ_r = np.asarray(anyhit["xla"](*args_a))
    occ_g = np.asarray(anyhit["native"](*args_a))
    occ_agree = (occ_r == occ_g).mean()
    say(f"parity closest: {n} rays ({int(act.sum())} active, "
        f"{int(rh.sum())} hits): hit+prim agree {agree.mean():.6f} "
        f"(>= 0.9999), |dt| > 1e-5 t on {int(dt_bad.sum())} of "
        f"{int(same.sum())} same-prim hits (must be 0)")
    say(f"parity anyhit: {len(sex)} shadow rays ({int(occ_r.sum())} "
        f"occluded): occlusion agrees {occ_agree:.6f} (>= 0.9999)")
    if agree.mean() < 0.9999 or dt_bad.any() or occ_agree < 0.9999:
        raise SystemExit("chip_smoke: native walk disagrees with the XLA "
                         "walk beyond tolerance")
    # one walk call alone: median host-clock time of 5 calls after warm-up
    for kind, fns, args in (("closest", closest, args_c),
                            ("anyhit", anyhit, args_a)):
        line = []
        for name, fn in fns.items():
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*args))
                ts.append(time.perf_counter() - t0)
            line.append(f"{name} {1e3 * sorted(ts)[2]:.3f} ms")
        say(f"walk call ({kind}, {n} rays): " + ", ".join(line))


def _frame(scene, camera, cfg, key):
    """Compile+first run, then one timed run; returns (fb, stats, dict)."""
    import jax
    import numpy as np
    from rtjax.render import render_frame
    t0 = time.perf_counter()
    fb, st = render_frame(scene, camera, cfg, key)
    jax.block_until_ready(fb)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    fb, st = render_frame(scene, camera, cfg, key)
    jax.block_until_ready(fb)
    secs = time.perf_counter() - t0
    rays = float(np.asarray(st["rays_traced"]))
    it = int(np.asarray(st["iterations"]))
    fb = np.asarray(fb)
    if fb.shape != (cfg.width * cfg.height, 3) or not np.isfinite(fb).all():
        raise SystemExit("chip_smoke: framebuffer not finite or misshapen")
    from rtjax.render.trace import resolve_mode
    say(f"  {resolve_mode(cfg):>6} {cfg.width}x{cfg.height}@"
        f"{cfg.num_samples}spp:"
        f" frame {secs:.3f} s, {rays / secs / 1e6:.2f} Mrays/s, "
        f"{rays:.0f} rays, {it} iterations, compile+first run "
        f"{first:.1f} s")
    return fb, dict(seconds=secs, rays=rays, iterations=it,
                    compile_first=first)


def _compare_images(a, b, w, h, block):
    """Frame-mean radiance rel diff per channel, and the RMS relative diff
    of ``block`` x ``block``-pixel block means, of two gamma-2
    framebuffers."""
    import numpy as np
    la = (a.reshape(h, w, 3).astype(np.float64)) ** 2
    lb = (b.reshape(h, w, 3).astype(np.float64)) ** 2
    mean_rel = np.abs(la.mean((0, 1)) / lb.mean((0, 1)) - 1)
    hb, wb = h // block, w // block
    ba = la[:hb * block, :wb * block].reshape(hb, block, wb, block, 3)
    bb = lb[:hb * block, :wb * block].reshape(hb, block, wb, block, 3)
    ba, bb = ba.mean((1, 3)), bb.mean((1, 3))
    rel = (ba - bb) / np.maximum(bb, 1e-6)
    return mean_rel, float(np.sqrt((rel ** 2).mean()))


def phase_frames(scene, camera, size=600, spp=10, head=(256, 64),
                 out_dir="out", coarse=75):
    import dataclasses
    import jax
    from rtjax import RenderConfig
    from rtjax.render import write_ppm
    key = jax.random.key(1)
    demo = RenderConfig(width=size, height=size, num_samples=spp,
                        max_bounces=10)
    say(f"demo frame (bunny Cornell {size}x{size} @ {spp} spp, 10 bounces):")
    fb_n, _ = _frame(scene, camera, demo, key)
    fb_x, _ = _frame(scene, camera,
                     dataclasses.replace(demo, traversal="xla"), key)
    # the noise floor: the native walk again with other samples.  The two
    # walks share their samples until a path changes fate, so their images
    # differ by less than two independent sample sets do; a bias in a
    # block would lift their difference above this floor.
    fb_s, _ = _frame(scene, camera, demo, jax.random.fold_in(key, 1))
    mean_rel, rms = _compare_images(fb_n, fb_x, size, size, 16)
    _, rms_c = _compare_images(fb_n, fb_x, size, size, coarse)
    noise_mean, noise = _compare_images(fb_n, fb_s, size, size, 16)
    _, noise_c = _compare_images(fb_n, fb_s, size, size, coarse)
    say(f"  native vs xla image: frame-mean radiance rel diff per channel "
        f"{[round(float(x), 6) for x in mean_rel]} (<= 0.01), 16x16 block "
        f"means RMS rel diff {rms:.6f} (<= 0.03), {coarse}x{coarse} blocks "
        f"{rms_c:.6f} (<= noise floor)")
    say(f"  noise floor (native, other samples): frame-mean "
        f"{[round(float(x), 6) for x in noise_mean]}, 16x16 blocks "
        f"{noise:.6f}, {coarse}x{coarse} blocks {noise_c:.6f}")
    if (mean_rel > 0.01).any() or rms > 0.03 or rms_c > noise_c:
        raise SystemExit("chip_smoke: native and xla demo images differ")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "demo_native.ppm")
    write_ppm(path, fb_n, size, size)
    with open(path) as f:
        header = [f.readline().strip() for _ in range(3)]
    if header != ["P3", f"{size} {size}", "255"]:
        raise SystemExit(f"chip_smoke: bad PPM header {header}")
    say(f"  wrote {path} (header {' / '.join(header)})")
    w, hspp = head
    say(f"headline frame (bunny Cornell {w}x{w} @ {hspp} spp, 10 bounces):")
    _frame(scene, camera, RenderConfig(width=w, height=w, num_samples=hspp,
                                       max_bounces=10), key)


def phase_four(scene, camera, size=600, spp=12):
    import jax
    import numpy as np
    from rtjax import RenderConfig
    from rtjax.parallel import make_mesh
    from rtjax.parallel.sharding import render_frame_linear_sharded
    from rtjax.render.wavefront import render_frame_linear
    devs = jax.devices()
    if len(devs) != 4:
        raise SystemExit(f"chip_smoke --four: {len(devs)} devices, need 4")
    cfg = RenderConfig(width=size, height=size, num_samples=spp,
                       max_bounces=10)
    key = jax.random.key(1)
    mesh = make_mesh(devs)
    sharded = jax.jit(render_frame_linear_sharded,
                      static_argnames=("cfg", "mesh"))
    t0 = time.perf_counter()
    fb4, st4 = sharded(scene, camera, cfg, key, mesh)
    jax.block_until_ready(fb4)
    first4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    fb4, st4 = sharded(scene, camera, cfg, key, mesh)
    jax.block_until_ready(fb4)
    secs4 = time.perf_counter() - t0

    import dataclasses
    one = jax.jit(render_frame_linear, static_argnames=("cfg",))
    local = dataclasses.replace(cfg, num_samples=cfg.num_samples // 4)
    acc = np.zeros((cfg.num_pixels, 3), np.float64)
    shard_rays = []
    for i in range(4):
        fb, st = one(scene, camera, local, jax.random.fold_in(key, i))
        acc += np.asarray(fb, np.float64)
        shard_rays.append(float(np.asarray(st["rays_traced"])))
    jax.block_until_ready(one(scene, camera, cfg, key))  # compile
    t0 = time.perf_counter()
    fb1, st1 = one(scene, camera, cfg, key)
    jax.block_until_ready(fb1)
    secs1 = time.perf_counter() - t0
    per_dev = [float(x) for x in np.asarray(st4["rays_per_device"])]
    fb4 = np.asarray(fb4, np.float64)
    if not np.isfinite(fb4).all():
        raise SystemExit("chip_smoke --four: framebuffer not finite")
    err = np.abs(fb4 - acc) / np.maximum(np.abs(acc), 1e-30)
    ok = np.allclose(fb4, acc, rtol=1e-5, atol=1e-6 * np.abs(acc).max())
    say(f"4-card demo frame {size}x{size} @ {spp} spp: per-card rays "
        f"{per_dev}; "
        f"same shards one after another on one card: {shard_rays}")
    say(f"  4-card frame {secs4:.3f} s (compile+first {first4:.1f} s) vs "
        f"1-card {spp} spp frame {secs1:.3f} s; sharded vs sequential shards "
        f"max rel diff {err.max():.3g} (rtol 1e-5: {'ok' if ok else 'FAIL'})")
    if not ok or per_dev != shard_rays:
        raise SystemExit("chip_smoke --four: sharded frame differs from the "
                         "sequential shards")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded frame")
    ap.add_argument("--out-dir", default="out",
                    help="where the demo frame's PPM is written")
    args = ap.parse_args()
    devs = phase_card()
    from rtjax.scenes import cornell_bunny
    t0 = time.perf_counter()
    scene, camera = cornell_bunny()
    say(f"scene: {scene.tris.num} triangles, {scene.bvh.num_nodes} nodes, "
        f"depth {scene.bvh.max_depth}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_build()
    if args.four:
        phase_four(scene, camera)
    else:
        phase_parity(scene, camera)
        phase_frames(scene, camera, out_dir=args.out_dir)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
