"""Feature-tier tests: instancing, environment light, checkpointing, CLI,
ray sorting."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtjax import Camera, RenderConfig, SceneBuilder, Transform
from rtjax.render import render_frame
from rtjax.render.checkpoint import render_checkpointed
from rtjax.render.sorting import ray_sort_keys, sort_permutation
from rtjax.scene.transform import scale, translate
from rtjax.utils.compare import mse

PYRAMID_V = np.array([[0, 0, 0], [0.2, 0, 0], [0.1, 0, -0.2],
                      [0.1, 0.25, -0.07]])
PYRAMID_F = np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3], [0, 1, 2]])


def _scene(instanced: bool):
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    red = b.make_matte((0.65, 0.05, 0.05))
    b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], white)
    b.add_triangles([0, 0, 0], [0, 0, -1], [1, 0, -1], white)
    b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3], [0.7, 0.9, -0.7],
                     (10, 10, 10), white)
    places = [Transform(translate(0.2, 0, -0.3)),
              Transform(scale(1.5, 1.5, 1.5)).composite(
                  translate(0.55, 0, -0.55))]
    if instanced:
        mid = b.register_mesh(PYRAMID_V, PYRAMID_F)
        for t in places:
            b.add_instance(mid, red, t)
    else:
        for t in places:
            b.add_mesh(PYRAMID_V, PYRAMID_F, red, transform=t)
    return b.build()


CAM = Camera.make((0.5, 0.6, 1.2), (0.5, 0.2, -0.4), (0, 1, 0), 45, 1.0)
CFG = RenderConfig(width=32, height=32, num_samples=48, max_bounces=3,
                   num_working_paths=4096)


@pytest.mark.slow
def test_instanced_matches_baked():
    f1, _ = render_frame(_scene(False), CAM, CFG, jax.random.key(1))
    f2, _ = render_frame(_scene(True), CAM, CFG, jax.random.key(1))
    a = np.asarray(f1).reshape(32, 32, 3)
    b = np.asarray(f2).reshape(32, 32, 3)
    assert abs(a.mean() - b.mean()) < 0.01
    assert mse(a, b) < 0.004


def test_instancing_memory_shares_blas():
    s = _scene(True)
    assert s.instances is not None and s.instances.num == 2
    assert len(s.blas) == 1  # one unique mesh for two placements
    assert s.blas[0].tris.num == 4


def test_environment_light_analytic():
    # a lone matte floor under a constant environment: with no occlusion the
    # rendered radiance equals env (perfect white furnace at albedo -> env *
    # albedo after one bounce + direct miss... camera rays that MISS get env
    # exactly; rays hitting the floor get env * albedo (cosine-integrated))
    b = SceneBuilder()
    alb = 0.6
    m = b.make_matte((alb, alb, alb))
    b.add_triangles([-50, 0, 50], [50, 0, 50], [50, 0, -50], m)
    b.add_triangles([-50, 0, 50], [-50, 0, -50], [50, 0, -50], m)
    b.set_environment((1.0, 1.0, 1.0))
    scene = b.build()
    cam = Camera.make((0, 2, 6), (0, 0, 0), (0, 1, 0), 50, 1.0)
    cfg = RenderConfig(width=24, height=24, num_samples=128, max_bounces=6,
                       num_working_paths=4096)
    fb, _ = render_frame(scene, cam, cfg, jax.random.key(2))
    img = np.asarray(fb).reshape(24, 24, 3)
    # sky pixels (top rows): value = sqrt(1.0) = 1
    assert abs(img[0:4].mean() - 1.0) < 0.02
    # floor pixels: geometric series alb + alb^2 * ... truncated; the first
    # bounce dominates: radiance in [alb, alb/(1-alb)); just require between
    floor = img[16:22].mean() ** 2  # undo gamma
    assert alb - 0.05 < floor < alb / (1 - alb) + 0.05


def test_checkpoint_resume(tmp_path):
    scene = _scene(False)
    cfg = RenderConfig(width=16, height=16, num_samples=16, max_bounces=2,
                       num_working_paths=1024)
    path = str(tmp_path / "ck.npz")
    full = render_checkpointed(scene, CAM, cfg, path=None, batch_spp=4,
                               verbose=False)
    # run 2 of 4 batches, "crash", then resume
    import numpy as np
    from rtjax.render.wavefront import render_frame_linear
    import dataclasses
    part = render_checkpointed(scene, CAM,
                               dataclasses.replace(cfg, num_samples=8),
                               path=path, batch_spp=4, verbose=False)
    ck = np.load(path)
    assert int(ck["batches_done"]) == 2
    resumed = render_checkpointed(scene, CAM, cfg, path=path, batch_spp=4,
                                  verbose=False)
    np.testing.assert_allclose(resumed, full, atol=1e-6)


def test_checkpoint_stats_count_batch_rays():
    """``return_stats`` sums the rays of exactly the batches rendered, each
    equal to a one-batch frame with the same folded key."""
    scene = _scene(False)
    cfg = RenderConfig(width=16, height=16, num_samples=8, max_bounces=2,
                       num_working_paths=1024)
    img, stats = render_checkpointed(scene, CAM, cfg, path=None, batch_spp=4,
                                     verbose=False, return_stats=True)
    plain = render_checkpointed(scene, CAM, cfg, path=None, batch_spp=4,
                                verbose=False)
    np.testing.assert_array_equal(img, plain)
    from rtjax.render.wavefront import render_frame_linear
    one = RenderConfig(width=16, height=16, num_samples=4, max_bounces=2,
                       num_working_paths=1024)
    base = jax.random.key(cfg.seed)
    want = sum(float(render_frame_linear(scene, CAM, one,
                                         jax.random.fold_in(base, b))[1]
                     ["rays_traced"]) for b in range(2))
    assert stats == {"rays_traced": want, "batches": 2}


def test_ray_sort_groups_octants(rng):
    n = 512
    o = jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    active = jnp.asarray(rng.random(n) > 0.3)
    keys = ray_sort_keys(o, d, jnp.zeros(3), jnp.ones(3), active)
    perm, inv = sort_permutation(keys)
    k = np.asarray(keys)[np.asarray(perm)]
    assert (np.diff(k) >= 0).all()          # sorted
    # inactive lanes at the back
    act_sorted = np.asarray(active)[np.asarray(perm)]
    first_inactive = np.argmin(act_sorted) if not act_sorted.all() else n
    assert not act_sorted[first_inactive:].any()
    # inverse permutation round-trips
    np.testing.assert_array_equal(np.asarray(perm)[np.asarray(inv)],
                                  np.arange(n))


def test_cli_renders(tmp_path):
    out = tmp_path / "cli.ppm"
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": "."}
    import os
    full_env = dict(os.environ)
    full_env.update(env)
    r = subprocess.run(
        [sys.executable, "-m", "rtjax", "render", "--scene", "cornell_planes",
         "--width", "16", "--height", "16", "--spp", "2", "--bounces", "2",
         "--pool", "512", "-o", str(out)],
        capture_output=True, text=True, env=full_env, timeout=560,
        cwd=os.path.join(os.path.dirname(__file__), os.pardir))
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
    from rtjax.render.film import read_ppm
    img = read_ppm(out)
    assert img.shape == (16, 16, 3)


def test_adaptive_sort_key_regimes(rng):
    """Depth-adaptive keys: deep rays bucket after shallow ones, deep keys
    are normal-octant-major, shallow keys position-major; inactive lanes
    still sort to the back."""
    from rtjax.render.sorting import (ray_sort_keys_adaptive_v3,
                                      ray_sort_keys_normal_pos_v3)
    n = 1024
    o = tuple(jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
              for _ in range(3))
    nrm = tuple(jnp.asarray(rng.standard_normal(n).astype(np.float32))
                for _ in range(3))
    bounces = jnp.asarray(rng.integers(0, 6, n).astype(np.int32))
    active = jnp.asarray(rng.random(n) > 0.2)
    lo = hi = None
    lo = tuple(jnp.float32(0.0) for _ in range(3))
    hi = tuple(jnp.float32(1.0) for _ in range(3))
    keys = np.asarray(ray_sort_keys_adaptive_v3(o, nrm, bounces, lo, hi,
                                                active)).astype(np.int64)
    act = np.asarray(active)
    deep = np.asarray(bounces) >= 2
    # every active deep key ranks above every active shallow key
    assert keys[act & deep].min(initial=1 << 62) > \
        keys[act & ~deep].max(initial=-1)
    # and below the inactive sentinel
    assert keys[act].max(initial=-1) < 0x7FFFFFFF
    # deep keys are octant-major on the NORMAL: same cell, flipped normal
    # octant -> differ in the top octant bits
    oc = ((np.asarray(nrm[0]) < 0).astype(int)
          | ((np.asarray(nrm[1]) < 0).astype(int) << 1)
          | ((np.asarray(nrm[2]) < 0).astype(int) << 2))
    got_oc = (keys[act & deep] >> 27) & 7
    np.testing.assert_array_equal(got_oc, oc[act & deep])
    # normal_pos: position-major with the normal octant in the low 3 bits
    k2 = np.asarray(ray_sort_keys_normal_pos_v3(o, nrm, lo, hi, active))
    np.testing.assert_array_equal(k2[act] & 7, oc[act])


def test_rgb9e5_roundtrip():
    """The sort bundle's beta/acc codec: <= 2^-9-relative on the dominant
    channel across the format's range, exact 0, NaN/inf-safe, idempotent."""
    import numpy as np

    from rtjax.render.sorting import rgb9e5_decode_v3, rgb9e5_encode_v3

    r = np.random.default_rng(0)
    v = np.exp(r.uniform(np.log(1e-4), np.log(6e4), (3, 8192))) \
        .astype(np.float32)
    v[:, 0] = 0.0
    v[0, 1], v[1, 2] = np.nan, np.inf
    w = rgb9e5_encode_v3(tuple(jnp.asarray(c) for c in v))
    d = np.stack([np.asarray(c) for c in rgb9e5_decode_v3(w)])
    # the codec refuses non-finite inputs outright (inf -> 0, matching the
    # engine's _accum policy), then clamps to the format range
    vc = np.where(np.isfinite(v), np.clip(v, 0, 511 / 512 * 65536), 0.0)
    m = vc.max(0)
    rel = np.abs(d - vc).max(0) / np.maximum(m, 1e-30)
    assert rel[m >= 2.0**-14].max() <= 2.0**-9
    assert (d[:, 0] == 0).all() and d[0, 1] == 0 and d[1, 2] == 0
    w2 = rgb9e5_encode_v3(tuple(jnp.asarray(c) for c in d))
    np.testing.assert_array_equal(np.asarray(w2), np.asarray(w))
