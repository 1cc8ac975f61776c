"""Homogeneous transforms (the slice of trimesh.transformations we need)."""

import numpy as np


def rotation_matrix(angle, direction, point=None):
    """4x4 rotation about an axis through `point` (Rodrigues form).

    Same contract as trimesh.transformations.rotation_matrix, which the
    reference calls at particle_system.py:429.
    """
    d = np.asarray(direction, np.float64)
    n = np.linalg.norm(d)
    if n == 0:
        d = np.array([0.0, 0.0, 1.0])
    else:
        d = d / n
    s, c = np.sin(angle), np.cos(angle)
    x, y, z = d
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    r = c * np.eye(3) + s * k + (1 - c) * np.outer(d, d)
    m = np.eye(4)
    m[:3, :3] = r
    if point is not None:
        point = np.asarray(point, np.float64)
        m[:3, 3] = point - r @ point
    return m
