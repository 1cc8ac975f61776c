"""Frame exporters: PLY point clouds, OBJ meshes, PNG renders.

Replaces the reference's GGUI/Taichi-tools export path
(run_simulation.py:96-113: window.write_image, ti.tools.PLYWriter,
trimesh OBJ export) with dependency-light host-side writers.  The PLY
series naming matches the reference exactly
("{scene}_output/particle_object_{id}_{frame:06}.ply" via
export_frame_ascii semantics).
"""

import os
import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def write_ply_ascii(path, positions):
    """ASCII PLY of vertex positions (ti.tools.PLYWriter.export_frame_ascii
    equivalent for the add_vertex_pos usage at run_simulation.py:105-107)."""
    positions = np.asarray(positions, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                "comment created by sph_taichi_tpu\n"
                f"element vertex {len(positions)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        np.savetxt(f, positions, fmt="%.6f")


def ply_series_path(series_prefix, frame):
    """ti.tools PLY series naming: prefix 'foo.ply' -> 'foo_000042.ply'."""
    base, ext = os.path.splitext(series_prefix)
    return f"{base}_{frame:06}{ext}"


# ---------------------------------------------------------------------------
# PNG (simple 3D point splatting — headless stand-in for the GGUI viewer)
# ---------------------------------------------------------------------------

class Camera:
    """Minimal pinhole camera mirroring the reference GGUI defaults
    (run_simulation.py:41-44: pos (5.5,2.5,4.0), lookat (-1,0,0),
    up (0,1,0), fov 70)."""

    def __init__(self, position=(5.5, 2.5, 4.0), lookat=(-1.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0), fov_deg=70.0, resolution=(1024, 1024)):
        self.position = np.asarray(position, np.float64)
        self.lookat = np.asarray(lookat, np.float64)
        self.up = np.asarray(up, np.float64)
        self.fov = np.deg2rad(fov_deg)
        self.resolution = resolution

    def project(self, points):
        fwd = self.lookat - self.position
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, self.up)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        rel = points - self.position
        z = rel @ fwd
        xx = rel @ right
        yy = rel @ up
        w, h = self.resolution
        f = (h / 2) / np.tan(self.fov / 2)
        valid = z > 1e-4
        zs = np.where(valid, z, 1.0)
        px = w / 2 + f * xx / zs
        py = h / 2 - f * yy / zs
        return px, py, z, valid


def render_png(path, positions, colors=None, camera=None,
               background=(0, 0, 0), point_px=2):
    """Depth-sorted point splat to a PNG (pure numpy + zlib)."""
    camera = camera or Camera()
    positions = np.asarray(positions, np.float64)
    w, h = camera.resolution
    img = np.zeros((h, w, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    if len(positions):
        px, py, z, valid = camera.project(positions)
        if colors is None:
            cols = np.full((len(positions), 3), 255, np.uint8)
        else:
            cols = np.asarray(colors, np.uint8)
        order = np.argsort(-z)  # far first so near overwrites
        px, py, z, valid = px[order], py[order], z[order], valid[order]
        cols = cols[order]
        xi = px.astype(int)
        yi = py.astype(int)
        ok = valid & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi, yi, cols = xi[ok], yi[ok], cols[ok]
        for dx in range(point_px):
            for dy in range(point_px):
                xs = np.clip(xi + dx, 0, w - 1)
                ys = np.clip(yi + dy, 0, h - 1)
                img[ys, xs] = cols
    write_png(path, img)


def write_png(path, img):
    """Minimal zlib PNG encoder (RGB8)."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# OBJ (shape-matched rigid meshes, run_simulation.py:108-112)
# ---------------------------------------------------------------------------

def shape_matched_vertices(rest_positions, rest_center, rotation, cm):
    """mesh.vertices = cm + R @ (restPosition - restCenterOfMass)
    (sph_base.py:253-257)."""
    rel = np.asarray(rest_positions) - np.asarray(rest_center)
    return np.asarray(cm) + rel @ np.asarray(rotation).T


def write_obj(path, mesh):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(mesh.export(file_type="obj"))
