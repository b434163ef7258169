"""Compile-time constants of the framework.

Rebuild of the reference's ``constant.hpp`` (constant.hpp:4-10).  Same defaults; here they are plain module
constants consumed by :class:`rtjax.config.RenderConfig`, which makes every one
of them overridable per render instead of compile-time fixed.
"""

import math

PI = math.pi
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi

# Maximum BVH depth (reference: constant.hpp:7).  The per-ray traversal stack
# holds BVH_MAX_DEPTH - 1 entries (device_stack.cuh:9).
BVH_MAX_DEPTH = 30

# Number of persistent path slots in the wavefront pool (constant.hpp:8).
NUM_WORKING_PATHS = 1 << 20

# Russian roulette: start after this many bounces, when max(beta) drops below
# the threshold (constant.hpp:9-10, render.cuh:112-124).
RR_THRESHOLD = 1.0
RR_START = 4

# Default RNG seed (reference: render.cuh:417).
RAND_SEED = 1

# Sentinel bounce count marking a slot as dead / awaiting regeneration
# (reference uses INT_MAX at render.cuh:81).
DEAD_BOUNCES = 2 ** 30

# Sentinel index meaning "no primitive / no light" (the reference uses null
# pointers; we use index -1 throughout the SoA tables).
INVALID_INDEX = -1
