"""Image-metric unit tests + wavefront semantic edge cases."""

import pytest
import jax
import numpy as np

from rtjax import Camera, RenderConfig, SceneBuilder
from rtjax.render import render_frame
from rtjax.utils.compare import mse, psnr, ssim


def test_metrics_identities(rng):
    a = rng.random((32, 32, 3))
    assert mse(a, a) == 0.0
    assert psnr(a, a) == float("inf")
    assert abs(ssim(a, a) - 1.0) < 1e-12
    b = a + 0.1
    assert mse(a, b) > 0
    assert ssim(a, b) < 1.0


def test_zero_bounces_is_direct_emission_only():
    # max_bounces=0: the only contribution is bounce-0 emission
    # (render.cuh:98-103); no NEE, no indirect light anywhere.
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    # wall behind the light, lit only indirectly -> must stay black
    b.add_triangles([-2, -2, -1], [2, -2, -1], [2, 2, -1], white)
    b.add_triangles([-2, -2, -1], [-2, 2, -1], [2, 2, -1], white)
    # emissive quad in front, radiance L = 4
    b.add_area_light([-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                     (4.0, 4.0, 4.0), white)
    b.add_area_light([-0.5, -0.5, 0], [-0.5, 0.5, 0], [0.5, 0.5, 0],
                     (4.0, 4.0, 4.0), white)
    scene = b.build()
    cam = Camera.make((0, 0, 3), (0, 0, 0), (0, 1, 0), 40, 1.0)
    cfg = RenderConfig(width=16, height=16, num_samples=8, max_bounces=0,
                       num_working_paths=1024)
    fb, _ = render_frame(scene, cam, cfg, jax.random.key(1))
    img = np.asarray(fb).reshape(16, 16, 3)
    # center pixels see the emitter: sqrt(4) = 2 exactly (every sample hits)
    np.testing.assert_allclose(img[7:9, 7:9], 2.0, atol=1e-5)
    # corner pixels see the unlit wall: zero
    np.testing.assert_allclose(img[0:2, 0:2], 0.0, atol=1e-6)


def test_spp_scaling_reduces_variance():
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    b.add_triangles([-2, 0, 2], [2, 0, 2], [2, 0, -2], white)
    b.add_triangles([-2, 0, 2], [-2, 0, -2], [2, 0, -2], white)
    b.add_area_light([-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5],
                     (8, 8, 8), white)
    scene = b.build()
    cam = Camera.make((0, 1.2, 2.5), (0, 0, 0), (0, 1, 0), 40, 1.0)

    imgs = {}
    for spp in (8, 64):
        cfg = RenderConfig(width=16, height=16, num_samples=spp,
                           max_bounces=3, num_working_paths=1024)
        a, _ = render_frame(scene, cam, cfg, jax.random.key(1))
        c, _ = render_frame(scene, cam, cfg, jax.random.key(2))
        imgs[spp] = mse(np.asarray(a), np.asarray(c))
    # inter-seed MSE must drop roughly linearly with spp
    assert imgs[64] < imgs[8] / 3.0


@pytest.mark.slow
def test_detailed_stats_counters():
    """detailed_stats=True (SURVEY.md §5 observability) adds a bounce-depth
    histogram and traversal work counters without changing the image."""
    import dataclasses

    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    b.add_triangles([-2, 0, 2], [2, 0, 2], [2, 0, -2], white)
    b.add_triangles([-2, 0, 2], [-2, 0, -2], [2, 0, -2], white)
    b.add_area_light([-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5],
                     (8, 8, 8), white)
    scene = b.build()
    cam = Camera.make((0, 1.2, 2.5), (0, 0, 0), (0, 1, 0), 40, 1.0)
    key = jax.random.key(1)

    for mode in ("native", "xla"):
        # direct_max_tris=0 keeps this tiny scene on the BVH kernels so
        # the walk counters stay meaningful (the direct fast path does
        # zero walk rounds by construction)
        cfg = RenderConfig(width=16, height=16, num_samples=8, max_bounces=4,
                           num_working_paths=1024, traversal=mode,
                           detailed_stats=True, direct_max_tris=0)
        fb, st = render_frame(scene, cam, cfg, key)
        hist = np.asarray(st["bounce_histogram"])
        assert hist.shape == (cfg.max_bounces + 1,)
        # every camera sample appears at depth 0; depths can only shrink
        assert hist[0] == cfg.num_pixels * cfg.num_samples
        assert (np.diff(hist) <= 0).all()
        assert int(st["node_steps"]) > 0 and int(st["leaf_visits"]) > 0
        # counters must not perturb the render
        fb0, st0 = render_frame(
            scene, cam, dataclasses.replace(cfg, detailed_stats=False), key)
        np.testing.assert_array_equal(np.asarray(fb), np.asarray(fb0))
        assert "bounce_histogram" not in st0


def test_windowed_flush_loses_no_radiance():
    """Under the sorted state the accumulator flush scatters only a
    suffix window of the pool; with a constant environment light every
    camera ray carries exactly env radiance, so ANY lost flush shows as a
    dark pixel.  (Regression for the window/sort gating.)"""
    b = SceneBuilder()
    m = b.make_matte((0.5, 0.5, 0.5))
    b.add_triangles([100, 100, 100], [101, 100, 100], [100, 101, 100], m)
    b.set_environment((0.49, 0.49, 0.49))
    scene = b.build()
    cam = Camera.make((0, 0, 3), (0, 0, 0), (0, 1, 0), 40, 1.0)
    # pool much smaller than the ray count: many refills, many windows
    cfg = RenderConfig(width=32, height=32, num_samples=16, max_bounces=3,
                       num_working_paths=1 << 10, traversal="native",
                       sort_rays=True)
    fb, _ = render_frame(scene, cam, cfg, jax.random.key(2))
    img = np.asarray(fb)
    # sqrt(0.49); atol covers the sort bundle's RGB9E5 acc quantization
    # (<= 2^-10 relative per carry) — a LOST flush errs by the full 0.7
    np.testing.assert_allclose(img, 0.7, atol=2e-3)


def test_adaptive_pool_size():
    """num_working_paths=None derives the pool from the workload, clamped
    to [2^17, 2^19]; explicit values always win."""
    from rtjax import RenderConfig

    assert RenderConfig(width=256, height=256,
                        num_samples=16).pool_size == 1 << 17
    assert RenderConfig(width=512, height=512,
                        num_samples=64).pool_size == 1 << 19
    assert RenderConfig(width=256, height=256,
                        num_samples=64).pool_size == 1 << 18
    assert RenderConfig(width=1920, height=1080,
                        num_samples=4).pool_size == 1 << 19
    assert RenderConfig(num_working_paths=512).pool_size == 512


def test_sort_every_conserves_radiance():
    """sort_every=2 skips the gen/flush block on alternate iterations; the
    constant-env probe (every camera ray carries exactly env radiance)
    catches any dropped or double-counted flush, and the cornell mean
    checks the estimator is unbiased under the staggered schedule."""
    import dataclasses

    b = SceneBuilder()
    m = b.make_matte((0.5, 0.5, 0.5))
    b.add_triangles([100, 100, 100], [101, 100, 100], [100, 101, 100], m)
    b.set_environment((0.49, 0.49, 0.49))
    scene = b.build()
    cam = Camera.make((0, 0, 3), (0, 0, 0), (0, 1, 0), 40, 1.0)
    cfg = RenderConfig(width=32, height=32, num_samples=16, max_bounces=3,
                       num_working_paths=1 << 10, traversal="native",
                       sort_rays=True, sort_every=2)
    fb, st = render_frame(scene, cam, cfg, jax.random.key(2))
    np.testing.assert_allclose(np.asarray(fb), 0.7, atol=2e-3)
    # exactly all camera samples were generated, none twice
    assert float(st["rays_traced"]) == 32 * 32 * 16

    from scenes import cornell
    scene2, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    cfg2 = RenderConfig(width=24, height=24, num_samples=48, max_bounces=4,
                        num_working_paths=1 << 12, sort_rays=True)
    fb1, _ = render_frame(scene2, cam, dataclasses.replace(cfg2,
                                                           sort_every=1),
                          jax.random.key(3))
    fb2, _ = render_frame(scene2, cam, dataclasses.replace(cfg2,
                                                           sort_every=2),
                          jax.random.key(3))
    a, b2 = np.asarray(fb1), np.asarray(fb2)
    assert np.isfinite(b2).all()
    assert abs(a.mean() - b2.mean()) < 0.01
