"""Multi-host (multi-process) sharded rendering over the JAX distributed
runtime: two CPU processes with 2 virtual devices each form a 4-device
mesh; the framebuffer psum crosses the process boundary (the DCN stand-in)
and must match a single-process 4-device render exactly."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
from rtjax.parallel import init_multihost, make_mesh, render_frame_sharded
init_multihost(coordinator=sys.argv[1], num_processes=2,
               process_id=int(sys.argv[2]))
import jax
import numpy as np
from tests.scenes import two_tri_box_scene
scene, cam, cfg = two_tri_box_scene(total_spp=8)
key = jax.random.PRNGKey(5)
mesh = make_mesh()
assert mesh.devices.size == 4, mesh.devices
fb, stats = render_frame_sharded(scene, cam, cfg, key, mesh)
print("FBMEAN", repr(float(np.asarray(fb).mean())),
      "RAYS", int(np.asarray(stats["rays_traced"])))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port



@pytest.mark.slow
def test_two_process_sharded_render_matches_single_process(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = (root + os.pathsep + os.path.join(root, "tests")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(i)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    means = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("FBMEAN")][0]
        means.append(float(line.split()[1]))
    # replicated output: both hosts hold the identical reduced framebuffer
    assert means[0] == means[1]

    # single-process 4-device reference
    from tests.scenes import two_tri_box_scene
    import jax
    from rtjax.parallel import make_mesh, render_frame_sharded
    scene, cam, cfg = two_tri_box_scene(total_spp=8)
    mesh = make_mesh(jax.devices()[:4])
    fb, _ = render_frame_sharded(scene, cam, cfg, jax.random.PRNGKey(5), mesh)
    ref = float(np.asarray(fb).mean())
    assert abs(ref - means[0]) < 1e-6, (ref, means[0])
