"""4x4 affine transforms for scene construction (host-side, NumPy).

Equivalent of the reference's matrix4x4.hpp and transform.hpp.
The reference applies a composite matrix to each vertex in a CPU loop
(transform.hpp:26-33, main.cu:71); here ``Transform.apply`` is one batched
``(M @ [v, 1])`` over the whole ``[N, 3]`` vertex array.
"""

from __future__ import annotations

import numpy as np


def translate(dx: float, dy: float, dz: float) -> np.ndarray:
    """Translation matrix (matrix4x4.hpp:22-27)."""
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = (dx, dy, dz)
    return m


def scale(sx: float, sy: float, sz: float) -> np.ndarray:
    """Scale matrix (matrix4x4.hpp:29-34)."""
    return np.diag([sx, sy, sz, 1.0]).astype(np.float64)


def rotate(axis, angle_rad: float) -> np.ndarray:
    """Axis-angle rotation via Rodrigues' formula (matrix4x4.hpp:36-56)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    x, y, z = a
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    r3 = np.eye(3) + s * k + (1.0 - c) * (k @ k)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r3
    return m


class Transform:
    """Mutable composite transform (transform.hpp:10-33).

    ``composite(other)`` left-multiplies: the new matrix is applied *after*
    the existing chain, matching ``matrix = other @ matrix``
    (transform.hpp:13-24).
    """

    def __init__(self, matrix: np.ndarray | None = None):
        self.matrix = np.eye(4, dtype=np.float64) if matrix is None else np.asarray(
            matrix, np.float64)

    def composite(self, other: np.ndarray) -> "Transform":
        self.matrix = np.asarray(other, np.float64) @ self.matrix
        return self

    def apply(self, vertices: np.ndarray) -> np.ndarray:
        """Apply to an ``[N, 3]`` vertex array (batched transform.hpp:26-33)."""
        v = np.asarray(vertices, np.float64)
        out = v @ self.matrix[:3, :3].T + self.matrix[:3, 3]
        return out
