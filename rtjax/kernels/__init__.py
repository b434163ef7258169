"""Device kernels: ray-BVH traversal (native walk through `jax.ffi` and the
XLA reference walk) and brute-force oracles."""

from .traversal import traverse_closest, traverse_anyhit  # noqa: F401
from .brute import closest_brute, anyhit_brute  # noqa: F401
