"""Unit tests for the two-level trace layer (rtjax/render/trace.py)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from rtjax import Camera, RenderConfig, SceneBuilder, Transform
from rtjax.render.trace import (gather_hit_materials, resolve_mode,
                                trace_anyhit, trace_closest)
from rtjax.scene.transform import rotate, scale, translate


def _inst_scene():
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    red = b.make_matte((0.6, 0.1, 0.1))
    # base floor at y=0
    b.add_triangles([-5, 0, 5], [5, 0, 5], [5, 0, -5], white)
    b.add_triangles([-5, 0, 5], [-5, 0, -5], [5, 0, -5], white)
    b.add_area_light([-1, 4, -1], [1, 4, -1], [1, 4, 1], (5, 5, 5), white)
    # a unit quad (two tris) at local z=0, instanced rotated+translated
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    f = np.array([[0, 1, 2], [0, 2, 3]])
    mid = b.register_mesh(v, f)
    t = Transform(rotate([0, 1, 0], np.pi / 2)).composite(
        translate(2.0, 0.5, 0.0))
    b.add_instance(mid, red, t)
    return b.build(), t


def test_trace_closest_hits_instance_in_world_space():
    scene, t = _inst_scene()
    cfg = RenderConfig()
    mode = resolve_mode(cfg)
    # ray aimed at the instanced quad: local (x,y,0) -> world after rot+T:
    # rotation by +90deg about y maps local +x to world -z; quad spans
    # world z in [0,-1], x = 2, y in [0.5, 1.5]
    o = jnp.asarray([[4.0, 1.0, -0.5]], jnp.float32)
    d = jnp.asarray([[-1.0, 0.0, 0.0]], jnp.float32)
    hit, tt, prim, src, nrm = trace_closest(
        scene, cfg, mode, o, d, jnp.full(1, jnp.inf),
        jnp.ones(1, bool))
    assert bool(hit[0])
    assert int(src[0]) == 1          # instance 1, not the base scene
    np.testing.assert_allclose(float(tt[0]), 2.0, rtol=1e-4)

    # same ray but higher: passes above the quad, hits nothing
    o2 = jnp.asarray([[4.0, 2.0, -0.5]], jnp.float32)
    hit2, *_ = trace_closest(scene, cfg, mode, o2, d,
                             jnp.full(1, jnp.inf), jnp.ones(1, bool))
    assert not bool(hit2[0])


def test_trace_anyhit_blocked_by_instance():
    scene, _ = _inst_scene()
    cfg = RenderConfig()
    mode = resolve_mode(cfg)
    o = jnp.asarray([[4.0, 1.0, -0.5]], jnp.float32)
    d = jnp.asarray([[-1.0, 0.0, 0.0]], jnp.float32)
    no_excl = jnp.full(1, -1, jnp.int32)
    occ = trace_anyhit(scene, cfg, mode, o, d,
                       jnp.full(1, 10.0), no_excl, jnp.ones(1, bool))
    assert bool(occ[0])
    # shortened ray stops before the quad
    occ2 = trace_anyhit(scene, cfg, mode, o, d,
                        jnp.full(1, 1.0), no_excl, jnp.ones(1, bool))
    assert not bool(occ2[0])


def test_trace_closest_world_normal_and_materials():
    """The kernel-returned normal is transformed by the instance cofactor
    matrix (== cross of the world-transformed edges); per-instance material
    override applies."""
    scene, t = _inst_scene()
    cfg = RenderConfig()
    mode = resolve_mode(cfg)
    o = jnp.asarray([[4.0, 1.0, -0.5]], jnp.float32)
    d = jnp.asarray([[-1.0, 0.0, 0.0]], jnp.float32)
    hit, tt, prim, src, nrm = trace_closest(
        scene, cfg, mode, o, d, jnp.full(1, jnp.inf),
        jnp.ones(1, bool))
    assert bool(hit[0])
    # world normal of the rotated quad faces +-x
    nn = np.asarray(nrm)[0]
    nn = nn / np.linalg.norm(nn)
    assert abs(abs(nn[0]) - 1.0) < 1e-4
    # per-instance material: red
    mtype, albedo, ior = gather_hit_materials(scene, src, prim)
    np.testing.assert_allclose(np.asarray(albedo)[0], [0.6, 0.1, 0.1],
                               atol=1e-6)

    # a base-scene hit (the floor) returns the stored cross(e1, e2) and the
    # base material
    o2 = jnp.asarray([[0.0, 3.0, 0.0]], jnp.float32)
    d2 = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    hit2, tt2, prim2, src2, nrm2 = trace_closest(
        scene, cfg, mode, o2, d2, jnp.full(1, jnp.inf),
        jnp.ones(1, bool))
    assert bool(hit2[0]) and int(src2[0]) == 0
    n2 = np.asarray(nrm2)[0]
    n2 = n2 / np.linalg.norm(n2)
    assert abs(abs(n2[1]) - 1.0) < 1e-5
    _, alb2, _ = gather_hit_materials(scene, src2, prim2)
    np.testing.assert_allclose(np.asarray(alb2)[0], [0.7, 0.7, 0.7],
                               atol=1e-6)


def test_instance_normal_nonuniform_scale():
    """Non-uniform scaling: the cofactor transform must keep the normal
    perpendicular to the world-space surface (a plain rotation of the local
    normal would not)."""
    b = SceneBuilder()
    red = b.make_matte((0.6, 0.1, 0.1))
    white = b.make_matte((0.7, 0.7, 0.7))
    b.add_area_light([-1, 4, -1], [1, 4, -1], [1, 4, 1], (5, 5, 5), white)
    # a unit quad in the local x-y plane, tilted 45deg about x then scaled
    # non-uniformly: world surface spans (x, diag(y,z)) with modified slope
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    f = np.array([[0, 1, 2], [0, 2, 3]])
    mid = b.register_mesh(v, f)
    t = Transform(rotate([1, 0, 0], np.pi / 4)).composite(
        scale(1.0, 3.0, 1.0))
    b.add_instance(mid, red, t)
    scene = b.build()
    cfg = RenderConfig()
    mode = resolve_mode(cfg)
    o = jnp.asarray([[0.5, 0.2, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    hit, tt, prim, src, nrm = trace_closest(
        scene, cfg, mode, o, d, jnp.full(1, jnp.inf),
        jnp.ones(1, bool))
    assert bool(hit[0]) and int(src[0]) == 1
    # two world-space surface tangents of the transformed quad
    m = np.asarray(t.matrix, np.float64)[:3, :3]
    tan1 = m @ np.array([1.0, 0.0, 0.0])
    tan2 = m @ np.array([0.0, 1.0, 0.0])
    nn = np.asarray(nrm, np.float64)[0]
    nn = nn / np.linalg.norm(nn)
    assert abs(np.dot(nn, tan1)) < 1e-5
    assert abs(np.dot(nn, tan2)) < 1e-5


@pytest.mark.parametrize("two_level", ["loop", "repass"])
def test_instanced_native_matches_xla_random_rays(two_level):
    """Both two-level strategies over the native walk must agree with the
    per-instance loop over the XLA walk on random rays: same hits, same
    (src, prim) identity, same occlusion."""
    import dataclasses
    scene = _mixed3_scene()
    cfg_x = RenderConfig(two_level="loop", direct_max_tris=0)
    cfg_n = dataclasses.replace(cfg_x, two_level=two_level)
    rng = np.random.default_rng(0)
    n = 2048
    o = rng.uniform(-0.3, 1.2, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tmax = jnp.full(n, jnp.inf)
    active = jnp.asarray(rng.random(n) > 0.1)

    hx = trace_closest(scene, cfg_x, "xla", o, d, tmax, active)
    hn = trace_closest(scene, cfg_n, "native", o, d, tmax, active)
    m = np.asarray(hx[0])
    assert m.sum() > 20, "test scene produced too few hits"
    assert (np.asarray(hx[3])[m] > 0).sum() > 5  # instanced hits present
    np.testing.assert_array_equal(m, np.asarray(hn[0]))
    np.testing.assert_allclose(np.asarray(hx[1])[m], np.asarray(hn[1])[m],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(hx[2])[m], np.asarray(hn[2])[m])
    np.testing.assert_array_equal(np.asarray(hx[3])[m], np.asarray(hn[3])[m])
    np.testing.assert_allclose(np.asarray(hx[4])[m], np.asarray(hn[4])[m],
                               rtol=1e-4, atol=1e-6)

    ex = jnp.full(n, -1, jnp.int32)
    ox = trace_anyhit(scene, cfg_x, "xla", o, d, jnp.full(n, 2.0), ex,
                      active)
    on = trace_anyhit(scene, cfg_n, "native", o, d, jnp.full(n, 2.0), ex,
                      active)
    np.testing.assert_array_equal(np.asarray(ox), np.asarray(on))


def test_mat_runs_chain_matches_gather():
    """The prim->material run-compare chain (scene.mat_runs) must agree with
    the [P] prim_material gather bit-for-bit, including miss lanes (-1)."""
    import dataclasses

    from rtjax.render.trace import _hit_material_index
    from rtjax.scene.scene import MAT_RUN_LIMIT, _material_runs

    rng = np.random.default_rng(3)
    sb = SceneBuilder()
    mats = [sb.make_matte((0.1 * k, 0.2, 0.3)) for k in range(5)]
    # three chunks with distinct materials -> few runs even after the BVH
    # leaf permutation shuffles spatially-interleaved triangles
    for k, m in enumerate(mats):
        base = rng.uniform(-1 + 0.4 * k, -0.6 + 0.4 * k, (40, 3))
        sb.add_triangles(base, base + [0.05, 0, 0], base + [0, 0.05, 0],
                         material=m)
    scene = sb.build()
    assert scene.mat_runs is not None
    prim = jnp.asarray(
        np.concatenate([[-1], rng.integers(0, scene.tris.num, 500)]),
        jnp.int32)
    src = jnp.zeros_like(prim)
    got = _hit_material_index(scene, src, prim)
    ref = _hit_material_index(dataclasses.replace(scene, mat_runs=None),
                              src, prim)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    # a map with more runs than the limit must fall back to the gather
    assert _material_runs(np.arange(MAT_RUN_LIMIT + 1, dtype=np.int32)) \
        is None
    assert _material_runs(np.zeros(0, np.int32)) is None


def _mixed3_scene():
    """3 instances of one mesh with mixed transforms + emissive base."""
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    red = b.make_matte((0.6, 0.1, 0.1))
    b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], white)
    b.add_triangles([0, 0, 0], [0, 0, -1], [1, 0, -1], white)
    b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3], [0.7, 0.9, -0.7],
                     (10, 10, 10), white)
    v = np.array([[0, 0, 0], [0.2, 0, 0], [0.1, 0, -0.2],
                  [0.1, 0.25, -0.07]])
    f = np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3], [0, 1, 2]])
    mid = b.register_mesh(v, f)
    for t in [Transform(translate(0.2, 0, -0.3)),
              Transform(scale(1.5, 1.5, 1.5)).composite(
                  translate(0.55, 0, -0.55)),
              Transform(rotate((0, 1, 0), 0.7)).composite(
                  translate(0.1, 0.2, -0.7))]:
        b.add_instance(mid, red, t)
    return b.build()


@pytest.mark.slow
def test_repass_two_level_matches_xla():
    """The multi-pass re-dispatch two-level path (two_level='repass') must
    agree with the per-instance XLA loop: same hits, same (src, prim)
    identity, same occlusion.  Covers overlapping mixed-transform instances
    (G=3, take_rows select chain) on random mixed-coherence rays."""
    import dataclasses

    scene = _mixed3_scene()
    # direct_max_tris=0: the stats assertion below is about the BVH
    # walk counters, which the small-scene direct fast path bypasses
    cfg_x = RenderConfig(direct_max_tris=0, two_level="loop")
    cfg_r = dataclasses.replace(cfg_x, two_level="repass")

    rng = np.random.default_rng(0)
    n = 2048
    o = rng.uniform(-0.3, 1.2, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tmax = jnp.full(n, jnp.inf)
    active = jnp.asarray(rng.random(n) > 0.1)

    hx = trace_closest(scene, cfg_x, "xla", o, d, tmax, active)
    hr = trace_closest(scene, cfg_r, "native", o, d, tmax, active)
    m = np.asarray(hx[0])
    assert m.sum() > 20
    np.testing.assert_array_equal(m, np.asarray(hr[0]))
    np.testing.assert_allclose(np.asarray(hx[1])[m], np.asarray(hr[1])[m],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(hx[2])[m], np.asarray(hr[2])[m])
    np.testing.assert_array_equal(np.asarray(hx[3])[m], np.asarray(hr[3])[m])
    np.testing.assert_allclose(np.asarray(hx[4])[m], np.asarray(hr[4])[m],
                               rtol=1e-4, atol=1e-6)

    ex = jnp.full(n, -1, jnp.int32)
    ox = trace_anyhit(scene, cfg_x, "xla", o, d, jnp.full(n, 2.0), ex,
                      active)
    orp = trace_anyhit(scene, cfg_r, "native", o, d, jnp.full(n, 2.0),
                       ex, active)
    np.testing.assert_array_equal(np.asarray(ox), np.asarray(orp))

    # with_stats plumbing: counters present and the walk did real work
    out = trace_closest(scene, cfg_r, "native", o, d, tmax, active,
                        with_stats=True)
    steps, leafs = out[5]
    assert int(steps) > 0 and int(leafs) > 0


@pytest.mark.slow
def test_repass_render_matches_loop_two_level():
    """A full wavefront render of an instanced scene must be (numerically)
    identical under two_level='repass' and 'loop': the same estimator sees
    the same hits, so images differ only by FP noise."""
    import dataclasses

    from rtjax.render import render_frame

    scene = _mixed3_scene()
    cam = Camera.make((0.5, 0.6, 0.8), (0.5, 0.15, -0.5), (0, 1, 0),
                      45.0, 1.0)
    base = RenderConfig(width=32, height=32, num_samples=4, max_bounces=4,
                        num_working_paths=4096)
    key = jax.random.key(7)
    fb_k, _ = render_frame(scene, cam,
                           dataclasses.replace(base, two_level="loop"),
                           key)
    fb_r, _ = render_frame(scene, cam,
                           dataclasses.replace(base, two_level="repass"),
                           key)
    fk, fr = np.asarray(fb_k), np.asarray(fb_r)
    assert np.isfinite(fr).all()
    np.testing.assert_allclose(fr, fk, rtol=1e-4, atol=1e-5)


def test_direct_small_scene_matches_xla():
    """The trivially-small-scene fast path (unrolled MT loop, no BVH walk)
    must agree with the XLA traversal exactly: same accept
    rule, leaf-order prim ids, unnormalized normals, and occlusion with
    per-lane exclusion."""
    import dataclasses
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    rng = np.random.default_rng(11)
    for _ in range(20):
        base = rng.uniform(-1, 1, 3)
        b.add_triangles(base, base + rng.uniform(-0.6, 0.6, 3),
                        base + rng.uniform(-0.6, 0.6, 3), white)
    b.add_area_light([-0.3, 1.5, -0.3], [0.3, 1.5, -0.3], [0.3, 1.5, 0.3],
                     (5, 5, 5), white)
    scene = b.build()
    assert scene.tris.num <= 64  # the direct gate must engage

    n = 512
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tmax = jnp.full(n, jnp.inf)
    active = jnp.asarray(rng.random(n) > 0.1)

    cfg = RenderConfig()
    cfg0 = dataclasses.replace(cfg, direct_max_tris=0)
    hd = trace_closest(scene, cfg, "native", o, d, tmax, active)
    hx = trace_closest(scene, cfg0, "xla", o, d, tmax, active)
    m = np.asarray(hx[0])
    assert m.sum() > 20
    np.testing.assert_array_equal(np.asarray(hd[0]), m)
    np.testing.assert_allclose(np.asarray(hd[1])[m], np.asarray(hx[1])[m],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(hd[2])[m], np.asarray(hx[2])[m])
    np.testing.assert_array_equal(np.asarray(hd[4])[m], np.asarray(hx[4])[m])

    ex = jnp.asarray(np.where(rng.random(n) > 0.5,
                              rng.integers(0, scene.tris.num, n),
                              -1).astype(np.int32))
    od = trace_anyhit(scene, cfg, "native", o, d, jnp.full(n, 2.0),
                      ex, active)
    ox = trace_anyhit(scene, cfg0, "xla", o, d, jnp.full(n, 2.0),
                      ex, active)
    np.testing.assert_array_equal(np.asarray(od), np.asarray(ox))
