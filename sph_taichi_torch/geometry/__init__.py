"""Mesh geometry: loading, transforms, voxelization (no external deps).

The reference leans on trimesh for its rigid-body pipeline
(particle_system.py:421-447): load -> apply_scale -> rotate about the
vertex mean -> translate -> fill_holes -> voxelized(pitch).fill() ->
interior+surface voxel centers as boundary particles.  trimesh is not
available here, so this package implements the same pipeline in numpy
(+ scipy.ndimage for the interior fill).
"""

import numpy as np

from sph_taichi_torch.geometry.mesh import TriMesh, load_mesh
from sph_taichi_torch.geometry.transforms import rotation_matrix
from sph_taichi_torch.geometry.voxelize import voxelize_fill


def load_rigid_body_points(rigid_body, pitch, scene_dir="."):
    """Reference load_rigid_body (particle_system.py:421-447).

    Returns (points[N,3] float32 voxel centers, transformed TriMesh).
    The mesh copy returned is the *pre-repair* backup the reference keeps
    for OBJ export (restPosition / restCenterOfMass come from it).
    """
    import os
    path = rigid_body["geometryFile"]
    if not os.path.isabs(path) and not os.path.exists(path):
        cand = os.path.join(scene_dir, path)
        if os.path.exists(cand):
            path = cand
    mesh = load_mesh(path)
    mesh.apply_scale(rigid_body["scale"])

    # reference uses a truncated pi constant (particle_system.py:427)
    angle = rigid_body["rotationAngle"] / 360 * 2 * 3.1415926
    direction = rigid_body["rotationAxis"]
    rot = rotation_matrix(angle, direction, mesh.vertices.mean(axis=0))
    mesh.apply_transform(rot)
    mesh.vertices = mesh.vertices + np.asarray(rigid_body["translation"])

    points = voxelize_fill(mesh.vertices, mesh.faces, pitch)
    return points.astype(np.float32), mesh
