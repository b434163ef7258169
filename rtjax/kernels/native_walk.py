"""Native BVH walks through ``jax.ffi``: one thread per ray on the GPU.

The walk of the CUDA reference (bvh.cuh:251-357): each ray walks the binary
BVH on its own with a private stack, nearer child first, intersecting
leaves inline.  The code is written once in ``native/bvh_walk.h`` and built
two ways:

- ``native/walk_cuda.cu`` with ``nvcc`` for ``sm_90a`` (the GPU path), and
- ``native/walk_host.cc`` with ``g++`` as a CPU FFI target, so the tests
  run the same arithmetic where there is no card.

Each library is built at first use into ``native/_build`` (listed in
``.gitignore``) under a name that hashes its sources, its flags and the JAX
version, so a stale library never loads.  A library that cannot be built or
loaded raises :class:`NativeWalkError`; nothing falls back to another walk.

Scene data is packed at scene build into 16-byte records (:func:`pack`):
a node is two ``int4`` (bounds as float bits plus ``left_first`` /
``num_prims``, the reference's node struct), a triangle three ``float4``
(``p0``, ``e1``, ``e2`` with the stored normal in the ``w`` lanes).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

SRC_DIR = os.path.join(os.path.dirname(__file__), "native")
BUILD_DIR = os.path.join(SRC_DIR, "_build")
HEADER = "bvh_walk.h"

# stack capacities compiled into the libraries (RTJAX_FOR_EACH_STACK)
STACK_SIZES = (32, 64, 128, 256)

# JAX backend name -> (FFI platform, source, handler symbol suffix)
_PLATFORMS = {
    "cpu": ("cpu", "walk_host.cc", "Host"),
    "gpu": ("CUDA", "walk_cuda.cu", "Cuda"),
}

CXX = "g++"
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                    "nvcc")

_lock = threading.Lock()
_loaded: dict = {}


class NativeWalkError(RuntimeError):
    """The native walk library could not be built or loaded."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WalkTables:
    """Scene records for the native walk (see module docstring)."""

    nodes: jax.Array  # [M, 8] int32: two int4 per node
    tris: jax.Array   # [P, 12] float32: three float4 per triangle


def pack(bmin, bmax, left_first, num_prims, p0, e1, e2, n) -> WalkTables:
    """Pack a (leaf-root padded) BVH and its leaf-order triangles."""
    m = len(left_first)
    nodes = np.empty((m, 8), np.int32)
    nodes[:, 0:3] = np.asarray(bmin, np.float32).view(np.int32)
    nodes[:, 3] = left_first
    nodes[:, 4:7] = np.asarray(bmax, np.float32).view(np.int32)
    nodes[:, 7] = num_prims
    tris = np.empty((len(p0), 12), np.float32)
    for k, v in enumerate((p0, e1, e2)):
        tris[:, 4 * k:4 * k + 3] = v
        tris[:, 4 * k + 3] = np.asarray(n, np.float32)[:, k]
    return WalkTables(nodes=jnp.asarray(nodes), tris=jnp.asarray(tris))


def _command(backend: str, src: str, out: str) -> list[str]:
    inc = jax.ffi.include_dir()
    if backend == "gpu":
        return [NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", inc, "-o", out, src]
    # -ffp-contract=off: no fused multiply-add, so the host build rounds
    # the same on every x86-64 host
    return [CXX, "-std=c++17", "-O3", "-shared", "-fPIC",
            "-ffp-contract=off", "-I", inc, "-o", out, src]


def library_path(backend: str, src_dir: str | None = None,
                 build_dir: str | None = None) -> str:
    """Where the library for ``backend`` lives: named by a hash of the
    header, the source, the compile flags and the JAX version."""
    src_dir, build_dir = src_dir or SRC_DIR, build_dir or BUILD_DIR
    _, src, _ = _PLATFORMS[backend]
    h = hashlib.sha256()
    for name in (HEADER, src):
        with open(os.path.join(src_dir, name), "rb") as f:
            h.update(f.read())
    flags = _command(backend, "SRC", "OUT")
    h.update(" ".join(flags[1:]).replace(jax.ffi.include_dir(), "").encode())
    h.update(jax.__version__.encode())
    return os.path.join(build_dir,
                        f"librtjax_walk_{backend}_{h.hexdigest()[:16]}.so")


def build(backend: str, src_dir: str | None = None,
          build_dir: str | None = None) -> tuple[str, float]:
    """Build the library for ``backend`` unless it exists; returns its path
    and the seconds spent compiling (0 when it was already there)."""
    src_dir, build_dir = src_dir or SRC_DIR, build_dir or BUILD_DIR
    path = library_path(backend, src_dir, build_dir)
    if os.path.exists(path):
        return path, 0.0
    _, src, _ = _PLATFORMS[backend]
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = _command(backend, os.path.join(src_dir, src), tmp)
    if shutil.which(cmd[0]) is None:
        os.unlink(tmp)
        raise NativeWalkError(f"compiler {cmd[0]!r} not found; the native "
                              f"{backend} walk cannot be built")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        os.unlink(tmp)
        raise NativeWalkError(f"building the native {backend} walk failed:\n"
                              f"{' '.join(cmd)}\n{r.stderr[-4000:]}")
    os.replace(tmp, path)  # atomic: concurrent builders never see a partial
    return path, seconds


def ensure_registered(backend: str | None = None) -> dict:
    """Build (if needed), load and register the walk for ``backend``
    (default: JAX's default backend).  Returns ``{"path", "build_seconds"}``
    of the library."""
    backend = backend or jax.default_backend()
    if backend not in _PLATFORMS:
        raise NativeWalkError(f"no native walk for backend {backend!r}")
    with _lock:
        if backend in _loaded:
            return _loaded[backend]
        path, seconds = build(backend)
        try:
            lib = ctypes.cdll.LoadLibrary(path)
        except OSError as e:
            raise NativeWalkError(f"cannot load {path}: {e}") from e
        platform, _, suffix = _PLATFORMS[backend]
        for kind in ("Closest", "Anyhit"):
            jax.ffi.register_ffi_target(
                f"rtjax_walk_{kind.lower()}",
                jax.ffi.pycapsule(getattr(lib, f"Rtjax{kind}{suffix}")),
                platform=platform)
        _loaded[backend] = {"path": path, "build_seconds": seconds}
        return _loaded[backend]


def stack_capacity(depth_needed: int) -> int:
    """Smallest compiled stack that holds ``depth_needed`` entries."""
    for s in STACK_SIZES:
        if depth_needed <= s:
            return s
    raise NativeWalkError(
        f"BVH needs a {depth_needed}-entry walk stack; the native walk is "
        f"built for at most {STACK_SIZES[-1]}")


def _lanes(n, *arrays, dtype):
    return [jnp.broadcast_to(jnp.asarray(a, dtype), (n,)) for a in arrays]


def closest(walk: WalkTables, o, d, tmax, active, *, stack_size: int,
            with_stats: bool = False):
    """Closest hit of ``[N]`` rays given as component triples.

    Returns ``(hit, t, prim, normal)`` with ``t = inf``, ``prim = -1`` and
    a zero normal on misses and inactive lanes; ``normal`` is the stored
    unnormalized ``cross(e1, e2)`` as a triple.  With ``with_stats`` a
    trailing ``(node_pair_steps, leaf_visits)`` pair of int32 sums follows.
    """
    ensure_registered()
    n = tmax.shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    st = jax.ShapeDtypeStruct((n if with_stats else 0,), jnp.int32)
    call = jax.ffi.ffi_call(
        "rtjax_walk_closest",
        (jax.ShapeDtypeStruct((n,), jnp.bool_), f32, i32, f32, f32, f32,
         st, st))
    hit, t, prim, nx, ny, nz, steps, leafs = call(
        walk.nodes, walk.tris, *_lanes(n, *o, *d, tmax, dtype=jnp.float32),
        *_lanes(n, active, dtype=jnp.bool_),
        stack_size=np.int64(stack_capacity(stack_size)))
    out = (hit, t, prim, (nx, ny, nz))
    if with_stats:
        out = out + ((jnp.sum(steps), jnp.sum(leafs)),)
    return out


def anyhit(walk: WalkTables, o, d, tmax, exclude, active, *,
           stack_size: int, with_stats: bool = False):
    """Occlusion of ``[N]`` rays with one excluded triangle index per ray;
    with ``with_stats`` returns ``(occluded, (steps, leafs))``."""
    ensure_registered()
    n = tmax.shape[0]
    st = jax.ShapeDtypeStruct((n if with_stats else 0,), jnp.int32)
    call = jax.ffi.ffi_call(
        "rtjax_walk_anyhit",
        (jax.ShapeDtypeStruct((n,), jnp.bool_), st, st))
    occ, steps, leafs = call(
        walk.nodes, walk.tris, *_lanes(n, *o, *d, tmax, dtype=jnp.float32),
        *_lanes(n, exclude, dtype=jnp.int32),
        *_lanes(n, active, dtype=jnp.bool_),
        stack_size=np.int64(stack_capacity(stack_size)))
    if with_stats:
        return occ, (jnp.sum(steps), jnp.sum(leafs))
    return occ
