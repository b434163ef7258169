"""The native BVH walk (kernels/native_walk.py) against the XLA walk.

On the CPU these run the host build of the same walk code the CUDA kernels
compile (native/bvh_walk.h).  Tests marked ``gpu`` need the card and skip
elsewhere; ``chip_smoke.py`` runs the same comparison there at full size.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtjax import RenderConfig, SceneBuilder
from rtjax.constants import BVH_MAX_DEPTH
from rtjax.kernels import native_walk
from rtjax.kernels.traversal import traverse_anyhit, traverse_closest
from rtjax.render.trace import resolve_mode

from conftest import BUNNY_PLY, random_triangles


def _soup_scene():
    rng = np.random.default_rng(5)
    b = SceneBuilder()
    p0, p1, p2 = random_triangles(rng, 600)
    b.add_triangles(p0, p1, p2, b.make_matte((0.5, 0.5, 0.5)))
    return b.build()


def _bunny_scene():
    from rtjax.scenes import cornell_bunny
    return cornell_bunny(BUNNY_PLY)[0]


SCENES = {"soup": _soup_scene, "bunny": _bunny_scene}
_built = {}


def _scene(name):
    if name not in _built:
        _built[name] = SCENES[name]()
    return _built[name]


def _rays(n, seed=0, lo=-1.2, hi=1.2):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.3, rng.uniform(0.05, 1.0, n),
                    np.inf).astype(np.float32)
    active = rng.random(n) > 0.1
    return (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
            jnp.asarray(active))


def _stack(scene):
    return max(BVH_MAX_DEPTH, scene.bvh.max_depth + 1)


def _native_closest(scene, o, d, tmax, active, with_stats=False):
    return native_walk.closest(scene.walk, tuple(o.T), tuple(d.T), tmax,
                               active, stack_size=_stack(scene),
                               with_stats=with_stats)


def _native_anyhit(scene, o, d, tmax, exclude, active, with_stats=False):
    return native_walk.anyhit(scene.walk, tuple(o.T), tuple(d.T), tmax,
                              exclude, active, stack_size=_stack(scene),
                              with_stats=with_stats)


def _check_closest(scene, o, d, tmax, active):
    ref = traverse_closest(scene.bvh, scene.tris, o, d, tmax, active,
                           stack_size=_stack(scene))
    hit, t, prim, n = _native_closest(scene, o, d, tmax, active)
    m = np.asarray(ref[0])
    np.testing.assert_array_equal(np.asarray(hit), m)
    np.testing.assert_array_equal(np.asarray(prim), np.asarray(ref[4]))
    # same operations in the same order, but XLA's CPU code fuses
    # multiply-adds and the host build does not: t differs by rounding,
    # amplified where the ray grazes a triangle (scene spans ~2 units)
    np.testing.assert_allclose(np.asarray(t)[m], np.asarray(ref[1])[m],
                               rtol=1e-5, atol=2e-6)
    assert np.isinf(np.asarray(t)[~m]).all()
    np.testing.assert_array_equal(np.stack([np.asarray(c) for c in n], 1),
                                  np.asarray(ref[5]))
    return m


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_matches_xla(name):
    scene = _scene(name)
    o, d, tmax, active = _rays(4096, seed=1, lo=-0.2, hi=1.2) \
        if name == "bunny" else _rays(4096, seed=1)
    m = _check_closest(scene, o, d, tmax, active)
    assert m.sum() > 200


@pytest.mark.parametrize("name", sorted(SCENES))
def test_anyhit_matches_xla(name):
    scene = _scene(name)
    o, d, tmax, active = _rays(4096, seed=2)
    rng = np.random.default_rng(2)
    exclude = jnp.asarray(np.where(rng.random(4096) < 0.5,
                                   rng.integers(0, scene.tris.num, 4096),
                                   -1).astype(np.int32))
    ref = traverse_anyhit(scene.bvh, scene.tris, o, d, tmax, exclude,
                          active, stack_size=_stack(scene))
    occ = _native_anyhit(scene, o, d, tmax, exclude, active)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))
    assert np.asarray(ref).sum() > 300


def test_anyhit_exclusion():
    """Excluding the only triangle on the ray's way clears the occlusion;
    excluding any other triangle does not."""
    b = SceneBuilder()
    m = b.make_matte((0.5, 0.5, 0.5))
    b.add_triangles([-1, -1, 0], [1, -1, 0], [0, 1, 0], m)
    b.add_triangles([5, 5, 5], [6, 5, 5], [5, 6, 5], m)
    scene = b.build(max_leaf_size=1)
    o = jnp.asarray([[0.0, 0.0, 2.0]] * 3, jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 3, jnp.float32)
    closest = _native_closest(scene, o, d, jnp.full(3, jnp.inf),
                              jnp.ones(3, bool))
    front = int(closest[2][0])
    other = 1 - front
    exclude = jnp.asarray([-1, front, other], jnp.int32)
    occ = _native_anyhit(scene, o, d, jnp.full(3, 10.0), exclude,
                         jnp.ones(3, bool))
    assert np.asarray(occ).tolist() == [True, False, True]


def test_inactive_lanes_and_finite_tmax():
    """Inactive lanes miss (t = inf, prim = -1, zero normal, not occluded);
    a tmax short of the surface misses, one past it hits."""
    scene = _scene("soup")
    o, d, _, _ = _rays(512, seed=3)
    far = jnp.full(512, jnp.inf)
    hit, t, prim, n = _native_closest(scene, o, d, far, jnp.ones(512, bool))
    h = np.asarray(hit)
    assert h.sum() > 50
    t_hit = np.where(h, np.asarray(t), 1.0)
    short = jnp.asarray(t_hit * 0.999, jnp.float32)
    hit2 = _native_closest(scene, o, d, short, jnp.ones(512, bool))[0]
    ref2 = traverse_closest(scene.bvh, scene.tris, o, d, short,
                            jnp.ones(512, bool), stack_size=_stack(scene))[0]
    np.testing.assert_array_equal(np.asarray(hit2), np.asarray(ref2))
    assert np.asarray(hit2)[h].sum() < h.sum()

    off = jnp.zeros(512, bool)
    hit3, t3, prim3, n3 = _native_closest(scene, o, d, far, off)
    assert not np.asarray(hit3).any()
    assert np.isinf(np.asarray(t3)).all()
    assert (np.asarray(prim3) == -1).all()
    assert all((np.asarray(c) == 0).all() for c in n3)
    occ = _native_anyhit(scene, o, d, far, jnp.full(512, -1, jnp.int32), off)
    assert not np.asarray(occ).any()


def test_leaf_root_scene():
    """A scene small enough to be one leaf gets the padded internal root
    (BuildResult.padded_arrays) and walks like the XLA walk."""
    b = SceneBuilder()
    m = b.make_matte((0.5, 0.5, 0.5))
    rng = np.random.default_rng(4)
    p0, p1, p2 = random_triangles(rng, 5)
    b.add_triangles(p0, p1, p2, m)
    scene = b.build()
    assert int(np.asarray(scene.bvh.num_prims)[0]) == 0
    assert scene.bvh.num_nodes == 3  # root + real leaf + dummy leaf
    o, d, tmax, active = _rays(4096, seed=4)
    assert _check_closest(scene, o, d, tmax, active).sum() > 10


def test_degenerate_build_deeper_than_max_depth():
    """300 coincident triangles force the at-cap median split past
    BVH_MAX_DEPTH; the walk sizes its stack from the real depth."""
    b = SceneBuilder()
    m = b.make_matte((0.5, 0.5, 0.5))
    b.add_triangles(np.tile([[0, 0, 0]], (300, 1)),
                    np.tile([[1, 0, 0]], (300, 1)),
                    np.tile([[0, 1, 0]], (300, 1)), m)
    scene = b.build(max_leaf_size=1)
    assert scene.bvh.max_depth > BVH_MAX_DEPTH
    n = 256
    o = jnp.asarray(np.tile([[0.2, 0.2, 1.0]], (n, 1)), jnp.float32)
    rng = np.random.default_rng(6)
    dd = np.tile([[0.0, 0.0, -1.0]], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    d = jnp.asarray(dd, jnp.float32)
    active = jnp.ones(n, bool)
    m_hit = _check_closest(scene, o, d, jnp.full(n, jnp.inf), active)
    assert m_hit.sum() > 100
    occ = _native_anyhit(scene, o, d, jnp.full(n, jnp.inf),
                         jnp.full(n, -1, jnp.int32), active)
    np.testing.assert_array_equal(np.asarray(occ), m_hit)


@pytest.mark.parametrize("kind", ["closest", "anyhit"])
def test_stats_match_xla(kind):
    """Per-ray node-pair steps and leaf visits, summed, equal the XLA
    walk's counters: both walks visit the same nodes."""
    scene = _scene("bunny")
    o, d, tmax, active = _rays(2048, seed=7, lo=-0.2, hi=1.2)
    if kind == "closest":
        ref = traverse_closest(scene.bvh, scene.tris, o, d, tmax, active,
                               stack_size=_stack(scene), with_stats=True)[6]
        got = _native_closest(scene, o, d, tmax, active, True)[4]
    else:
        ex = jnp.full(2048, -1, jnp.int32)
        ref = traverse_anyhit(scene.bvh, scene.tris, o, d, tmax, ex, active,
                              stack_size=_stack(scene), with_stats=True)[1]
        got = _native_anyhit(scene, o, d, tmax, ex, active, True)[1]
    assert int(ref[0]) > 0 and int(ref[1]) > 0
    assert (int(got[0]), int(got[1])) == (int(ref[0]), int(ref[1]))


def test_call_inside_while_loop():
    """The FFI call composes with lax.while_loop (the engine's frame loop):
    each trip shortens tmax to the previous hit and must keep hitting the
    same triangle until tmax excludes it."""
    scene = _scene("soup")
    o, d, _, active = _rays(512, seed=8)
    tmax0 = jnp.full(512, jnp.inf)

    def body(c):
        i, tmax, hits = c
        hit, t, _, _ = _native_closest(scene, o, d, tmax, active)
        return i + 1, jnp.where(hit, t * 0.5, tmax), hits + hit

    _, _, hits = jax.jit(lambda: jax.lax.while_loop(
        lambda c: c[0] < 3, body, (0, tmax0, jnp.zeros(512, jnp.int32))))()
    first = np.asarray(_native_closest(scene, o, d, tmax0, active)[0])
    h = np.asarray(hits)
    assert (h[~first] == 0).all() and (h[first] >= 1).all()


def test_call_inside_shard_map():
    """Rays split over the 8 virtual CPU devices give the unsplit result."""
    from jax.sharding import PartitionSpec as P
    from rtjax.parallel import make_mesh
    scene = _scene("soup")
    mesh = make_mesh()
    assert mesh.devices.size == 8
    o, d, tmax, active = _rays(1024, seed=9)

    def shard(o, d, tmax, active):
        hit, t, prim, _ = _native_closest(scene, o, d, tmax, active)
        return hit, prim

    f = jax.shard_map(shard, mesh=mesh, in_specs=(P("chips"),) * 4,
                      out_specs=(P("chips"), P("chips")))
    hit, prim = jax.jit(f)(o, d, tmax, active)
    ref = _native_closest(scene, o, d, tmax, active)
    np.testing.assert_array_equal(np.asarray(hit), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(prim), np.asarray(ref[2]))


def test_render_native_matches_xla():
    """A whole frame through render_frame: the two walks find the same
    hits, so the images agree to float rounding."""
    from rtjax.render import render_frame
    from scenes import cornell, default_camera
    scene, _ = cornell(max_leaf_size=2)
    cfg = RenderConfig(width=16, height=16, num_samples=8, max_bounces=4,
                       num_working_paths=1024, direct_max_tris=0)
    key = jax.random.key(4)
    fb_n, st_n = render_frame(scene, default_camera(), cfg, key)
    fb_x, st_x = render_frame(scene, default_camera(),
                              dataclasses.replace(cfg, traversal="xla"), key)
    assert float(st_n["rays_traced"]) == float(st_x["rays_traced"])
    np.testing.assert_allclose(np.asarray(fb_n), np.asarray(fb_x),
                               rtol=1e-4, atol=1e-5)


def test_resolve_mode():
    assert resolve_mode(RenderConfig()) == "native"
    assert resolve_mode(RenderConfig(traversal="native")) == "native"
    assert resolve_mode(RenderConfig(traversal="xla")) == "xla"
    with pytest.raises(ValueError):
        resolve_mode(RenderConfig(traversal="pallas"))


def test_stack_capacity_choice():
    """The smallest compiled stack that holds the build's depth; deeper
    trees are refused instead of overflowing."""
    assert native_walk.stack_capacity(31) == 32
    assert native_walk.stack_capacity(33) == 64
    assert native_walk.stack_capacity(256) == 256
    with pytest.raises(native_walk.NativeWalkError):
        native_walk.stack_capacity(257)


def test_pack_layout():
    """Node records carry bounds as float bits plus left_first/num_prims;
    triangle records carry p0/e1/e2 with the normal in the w lanes."""
    scene = _scene("soup")
    nodes = np.asarray(scene.walk.nodes)
    tris = np.asarray(scene.walk.tris)
    np.testing.assert_array_equal(nodes[:, 0:3].view(np.float32),
                                  np.asarray(scene.bvh.bmin))
    np.testing.assert_array_equal(nodes[:, 4:7].view(np.float32),
                                  np.asarray(scene.bvh.bmax))
    np.testing.assert_array_equal(nodes[:, 3],
                                  np.asarray(scene.bvh.left_first))
    np.testing.assert_array_equal(nodes[:, 7],
                                  np.asarray(scene.bvh.num_prims))
    for k, f in enumerate(("p0", "e1", "e2")):
        np.testing.assert_allclose(tris[:, 4 * k:4 * k + 3],
                                   np.asarray(getattr(scene.tris, f)),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tris[:, 3::4], np.asarray(scene.tris.n),
                               rtol=1e-5, atol=1e-6)


def test_library_rebuilt_when_source_changes(tmp_path):
    """The library's name hashes its sources: an edited source builds a new
    library instead of loading the stale one."""
    src = tmp_path / "src"
    shutil.copytree(native_walk.SRC_DIR, src,
                    ignore=shutil.ignore_patterns("_build"))
    out = tmp_path / "build"
    path1, secs1 = native_walk.build("cpu", str(src), str(out))
    assert secs1 > 0 and os.path.exists(path1)
    assert native_walk.build("cpu", str(src), str(out)) == (path1, 0.0)
    with open(src / native_walk.HEADER, "a") as f:
        f.write("\n// edited\n")
    path2, secs2 = native_walk.build("cpu", str(src), str(out))
    assert path2 != path1 and secs2 > 0 and os.path.exists(path2)


def test_native_raises_when_library_unavailable(monkeypatch, tmp_path):
    """With no compiler and no built library, "native" raises; it never
    switches to the XLA walk."""
    monkeypatch.setattr(native_walk, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_walk, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(native_walk, "_loaded", {})
    scene = _scene("soup")
    o, d, tmax, active = _rays(64, seed=10)
    from rtjax.render.trace import trace_closest
    with pytest.raises(native_walk.NativeWalkError):
        trace_closest(scene, RenderConfig(traversal="native"), "native",
                      o, d, tmax, active)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU (run: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/)")


@pytest.mark.gpu
def test_cuda_walk_matches_xla(gpu):
    """The CUDA build against the XLA walk on the card."""
    scene = _scene("bunny")
    o, d, tmax, active = _rays(1 << 16, seed=11, lo=-0.2, hi=1.2)
    ref = traverse_closest(scene.bvh, scene.tris, o, d, tmax, active,
                           stack_size=_stack(scene))
    hit, t, prim, _ = _native_closest(scene, o, d, tmax, active)
    agree = (np.asarray(hit) == np.asarray(ref[0])) & \
        (np.asarray(prim) == np.asarray(ref[4]))
    # nvcc and XLA contract multiply-adds differently: near-ties may flip
    assert agree.mean() >= 0.9999
    both = np.asarray(hit) & np.asarray(ref[0])
    rt = np.asarray(ref[1])[both]
    assert (np.abs(np.asarray(t)[both] - rt) <= 1e-5 * rt).all()
