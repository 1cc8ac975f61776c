"""Minimal triangle-mesh container + OBJ/STL loaders (numpy only)."""

import struct

import numpy as np


class TriMesh:
    """Vertices (V,3) float64 + triangle faces (F,3) int64."""

    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)

    def copy(self):
        return TriMesh(self.vertices.copy(), self.faces.copy())

    def apply_scale(self, scale):
        """Per-axis scale (trimesh.apply_scale with a 3-vector)."""
        self.vertices = self.vertices * np.asarray(scale, np.float64)
        return self

    def apply_transform(self, matrix4):
        v = np.concatenate(
            [self.vertices, np.ones((len(self.vertices), 1))], axis=1)
        self.vertices = (v @ np.asarray(matrix4).T)[:, :3]
        return self

    def triangles(self):
        return self.vertices[self.faces]   # (F, 3, 3)

    def export(self, file_type="obj"):
        """OBJ text export (run_simulation.py:110-112 writes this)."""
        assert file_type == "obj"
        lines = [f"v {x:.8f} {y:.8f} {z:.8f}" for x, y, z in self.vertices]
        lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in self.faces]
        return "\n".join(lines) + "\n"


def load_obj(path):
    """Wavefront OBJ: v + f records, fan-triangulating polygons.
    Face indices may be v, v/vt, v/vt/vn, or v//vn; negatives allowed."""
    vertices, faces = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]),
                                 float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    s = tok.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.array(vertices), np.array(faces))


def load_stl(path):
    """Binary or ASCII STL. Duplicate vertices are merged exactly."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header; try ASCII first
        try:
            return _load_stl_ascii(path)
        except Exception:
            pass
    return _load_stl_binary(path)


def _load_stl_binary(path):
    with open(path, "rb") as f:
        f.read(80)
        (n_tri,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
    rec = data.reshape(n_tri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n_tri, 4, 3)
    tri_verts = floats[:, 1:4, :].reshape(-1, 3).astype(np.float64)
    return _dedupe(tri_verts)


def _load_stl_ascii(path):
    verts = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            t = line.split()
            if t and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    if not verts or len(verts) % 3:
        raise ValueError("not a valid ASCII STL")
    return _dedupe(np.array(verts))


def _dedupe(tri_verts):
    uniq, inv = np.unique(tri_verts, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    return TriMesh(uniq, faces)


def load_mesh(path):
    low = path.lower()
    if low.endswith(".obj"):
        return load_obj(path)
    if low.endswith(".stl"):
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {path}")
