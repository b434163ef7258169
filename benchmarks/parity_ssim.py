"""Render the demo scene with the fixed estimator and with
reference_parity=True (the CUDA binary's exact estimator, see
render/wavefront.py deviations 2-4), and publish their delta — the
SSIM-vs-CUDA protocol of BASELINE.md.

Usage: python benchmarks/parity_ssim.py [size=1024] [spp=1024]
Writes artifacts/parity_{fixed,reference}_<size>_<spp>spp.ppm and prints
MSE / PSNR / SSIM between the two converged images.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main():
    import numpy as np
    from rtjax import RenderConfig
    from rtjax.render.checkpoint import render_checkpointed
    from rtjax.render.film import write_ppm
    from rtjax.scenes import cornell_bunny
    from rtjax.utils.cache import enable_compile_cache
    from rtjax.utils.compare import mse, psnr, ssim
    enable_compile_cache()

    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 1024

    scene, cam = cornell_bunny()
    os.makedirs("artifacts", exist_ok=True)
    imgs = {}
    for name, parity in (("fixed", False), ("reference", True)):
        cfg = RenderConfig(width=size, height=size, num_samples=spp,
                           max_bounces=10, reference_parity=parity)
        ck = f"artifacts/parity_{name}_{size}_{spp}spp.npz"
        t0 = time.time()
        fb = render_checkpointed(scene, cam, cfg, ck,
                                 batch_spp=min(spp, 32))
        print(f"{name}: {time.time()-t0:.0f}s")
        img = np.asarray(fb).reshape(size, size, 3)
        imgs[name] = img
        write_ppm(f"artifacts/parity_{name}_{size}_{spp}spp.ppm",
                  img.reshape(-1, 3), size, size)

    a, b = imgs["fixed"], imgs["reference"]
    print(f"fixed mean {a.mean():.5f}  reference mean {b.mean():.5f}  "
          f"rel delta {abs(a.mean()-b.mean())/a.mean():.4%}")
    print(f"MSE {mse(a, b):.3e}  PSNR {psnr(a, b):.2f} dB  "
          f"SSIM {ssim(a, b):.4f}")


if __name__ == "__main__":
    main()
