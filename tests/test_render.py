"""Integration/golden tests: wavefront engine vs the independent NumPy oracle.

The oracle uses pure BSDF sampling; the engine uses NEE + MIS.  Both are
unbiased estimators of the same radiance, so converged images must agree to
within noise (calibrated: cross-MSE ~= self-noise MSE ~ 1e-3 at these spp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtjax import Camera, RenderConfig, SceneBuilder
from rtjax.render import render_frame, to_u8, write_ppm, read_ppm
from rtjax.utils.compare import mse, ssim

from oracle import render_oracle_image
from scenes import cornell, default_camera


@pytest.fixture(scope="module")
def matte_pair():
    return cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))


def test_cornell_matches_oracle(matte_pair):
    scene, osc = matte_pair
    cam = default_camera()
    w = h = 32
    img_o = render_oracle_image(osc, cam, w, h, 600, 4, seed=5)
    cfg = RenderConfig(width=w, height=h, num_samples=64, max_bounces=4,
                       num_working_paths=4096)
    fb, stats = render_frame(scene, cam, cfg, jax.random.key(1))
    img_r = np.asarray(fb).reshape(h, w, 3)

    assert np.isfinite(img_r).all() and (img_r >= 0).all()
    assert abs(img_o.mean() - img_r.mean()) < 0.01
    assert mse(img_o, img_r) < 0.004
    assert np.abs(img_o - img_r).mean() < 0.05
    assert int(stats["iterations"]) > 0
    # every camera ray traced at least once: 32*32*64 primaries
    assert float(stats["rays_traced"]) >= w * h * 64


def test_cornell_specular_matches_oracle():
    extra = [
        (((0.1, 0, -0.2), (0.45, 0, -0.2), (0.3, 0.5, -0.45)), "mirror"),
        (((0.55, 0, -0.2), (0.9, 0, -0.2), (0.7, 0.5, -0.45)), ("glass", 1.5)),
    ]
    scene, osc = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0), extra=extra)
    cam = default_camera()
    w = h = 32
    img_o = render_oracle_image(osc, cam, w, h, 800, 6, seed=5)
    cfg = RenderConfig(width=w, height=h, num_samples=96, max_bounces=6,
                       num_working_paths=4096)
    fb, _ = render_frame(scene, cam, cfg, jax.random.key(1))
    img_r = np.asarray(fb).reshape(h, w, 3)
    assert abs(img_o.mean() - img_r.mean()) < 0.015
    assert mse(img_o, img_r) < 0.004


def test_one_sample_mis_matches_default(matte_pair):
    """one_sample_mis reuses the path BSDF sample for the BSDF-MIS light
    channel (resolved from the path ray's closest hit, zero extra rays).
    Same estimator expectation as the default two-sample form, so the
    converged images must agree within Monte-Carlo noise — and the mode
    must trace FEWER rays (no CH shadow channel)."""
    scene, _ = matte_pair
    cam = default_camera()
    w = h = 32
    cfg = RenderConfig(width=w, height=h, num_samples=64, max_bounces=4,
                       num_working_paths=4096)
    cfg1 = RenderConfig(width=w, height=h, num_samples=64, max_bounces=4,
                        num_working_paths=4096, one_sample_mis=True)
    fb2, st2 = render_frame(scene, cam, cfg, jax.random.key(3))
    fb1, st1 = render_frame(scene, cam, cfg1, jax.random.key(7))
    img2 = np.asarray(fb2).reshape(h, w, 3)
    img1 = np.asarray(fb1).reshape(h, w, 3)
    assert np.isfinite(img1).all() and (img1 >= 0).all()
    assert abs(img1.mean() - img2.mean()) < 0.01
    assert mse(img1, img2) < 0.004
    assert float(st1["rays_traced"]) < float(st2["rays_traced"])

    with pytest.raises(ValueError):
        bad = RenderConfig(width=w, height=h, one_sample_mis=True,
                           reference_parity=True)
        render_frame(scene, cam, bad, jax.random.key(0))


def test_render_deterministic(matte_pair):
    scene, _ = matte_pair
    cam = default_camera()
    cfg = RenderConfig(width=32, height=32, num_samples=64, max_bounces=4,
                       num_working_paths=4096)
    fb1, _ = render_frame(scene, cam, cfg, jax.random.key(9))
    fb2, _ = render_frame(scene, cam, cfg, jax.random.key(9))
    # scatter-add accumulation is deterministic (unlike CUDA float atomics)
    np.testing.assert_array_equal(np.asarray(fb1), np.asarray(fb2))


def test_direct_point_light_analytic():
    # single floor + point light, 1 bounce: L = albedo/pi * cos * I / d^2
    b = SceneBuilder()
    alb = (0.6, 0.6, 0.6)
    m = b.make_matte(alb)
    b.add_triangles([-5, 0, 5], [5, 0, 5], [5, 0, -5], m)
    b.add_triangles([-5, 0, 5], [-5, 0, -5], [5, 0, -5], m)
    lp = np.array([0.0, 2.0, 0.0])
    intensity = np.array([10.0, 10.0, 10.0])
    b.add_point_light(lp, intensity)
    scene = b.build()

    cam = Camera.make((0, 3, 4), (0, 0, 0), (0, 1, 0), 40.0, 1.0)
    cfg = RenderConfig(width=16, height=16, num_samples=32, max_bounces=1,
                       num_working_paths=2048)
    fb, _ = render_frame(scene, cam, cfg, jax.random.key(4))
    img = np.asarray(fb).reshape(16, 16, 3)

    # expected at the exact hit point of each pixel-center ray
    o, d = cam.get_rays(
        jnp.asarray((np.arange(16)[None, :].repeat(16, 0).ravel() + 0.5) / 16,
                    jnp.float32),
        jnp.asarray((np.arange(16)[:, None].repeat(16, 1).ravel() + 0.5) / 16,
                    jnp.float32))
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    t = -o[:, 1] / d[:, 1]
    p = o + t[:, None] * d
    tol = np.abs(d[:, 1]) > 1e-3
    rel = lp - p
    d2 = np.sum(rel ** 2, -1)
    cos = np.maximum(rel[:, 1], 0) / np.sqrt(d2)
    expect = (np.asarray(alb) / np.pi)[None] * (cos * 10.0 / d2)[:, None]
    expect = np.sqrt(expect)  # gamma
    got = img.reshape(-1, 3)
    # exclude near-horizon pixels (jitter nonlinearity breaks the
    # pixel-center approximation) and pixels straddling the finite floor edge
    ok = tol & (t > 0) & (t < 12) & (np.abs(p[:, 0]) < 4.0) & \
        (np.abs(p[:, 2]) < 4.0)
    assert ok.sum() > 100
    np.testing.assert_allclose(got[ok], expect[ok], atol=0.03)


def test_bounce0_emission_visible(matte_pair):
    # camera looking straight at the ceiling light sees L on bounce 0
    scene, _ = matte_pair
    cam = Camera.make((0.5, 0.2, -0.5), (0.5, 1.0, -0.5), (0, 0, 1), 60.0, 1.0)
    cfg = RenderConfig(width=8, height=8, num_samples=16, max_bounces=1,
                       num_working_paths=1024)
    fb, _ = render_frame(scene, cam, cfg, jax.random.key(2))
    img = np.asarray(fb).reshape(8, 8, 3)
    # center pixels look at the emitter: value >= sqrt(L) (plus bounce light)
    assert img[3:5, 3:5].min() >= np.sqrt(4.0) - 0.05


def test_ppm_roundtrip(tmp_path, matte_pair):
    scene, _ = matte_pair
    cam = default_camera()
    cfg = RenderConfig(width=16, height=16, num_samples=8, max_bounces=2,
                       num_working_paths=1024)
    fb, _ = render_frame(scene, cam, cfg, jax.random.key(3))
    path = tmp_path / "img.ppm"
    write_ppm(path, np.asarray(fb), 16, 16)
    img = read_ppm(path)
    np.testing.assert_array_equal(img, to_u8(np.asarray(fb), 16, 16))


def test_windowed_shading_matches_full(matte_pair):
    """Prefix-windowed shading (shade_chunks > 1) must be bit-identical to
    full-width shading: beyond-window lanes are zero-filled and every
    consumer is masked; in-window lanes compute the same math."""
    scene, _ = matte_pair
    cam = default_camera()
    base = dict(width=24, height=24, num_samples=16, max_bounces=4,
                num_working_paths=2048, traversal="native",
                sort_rays=True)
    fb_w, _ = render_frame(scene, cam, RenderConfig(**base, shade_chunks=8),
                           jax.random.key(3))
    fb_f, _ = render_frame(scene, cam, RenderConfig(**base, shade_chunks=1),
                           jax.random.key(3))
    np.testing.assert_array_equal(np.asarray(fb_w), np.asarray(fb_f))
