"""Scene construction: JSON config -> (SimParams, Particles, SceneObjects).

Host-side (numpy) re-implementation of the reference's ParticleSystem
construction path (particle_system.py:12-211):
- fluid/rigid blocks sampled as particle_diameter lattices with np.arange
  (identical off-by-one/count semantics, :450-456 and :469-483),
- rigid mesh bodies loaded, scaled, rotated about the vertex mean,
  translated, voxelized at pitch=particle_diameter and interior-filled
  (:421-447) — via sph_taichi_torch.geometry (no trimesh dependency),
- per-particle init: x0=x, m_V=m_V0, m=m_V0*density (add_particle, :223-235).

Counterpart of ``sph_taichi_tpu/scene.py`` without the TPU engine's
capacity planning: the CUDA engine walks cell ranges and has no caps.  The
output is one padded SoA Particles tuple on the requested device.
"""

import dataclasses
from functools import reduce

import numpy as np

from sph_taichi_torch.config import SimConfig
from sph_taichi_torch.state import (
    MATERIAL_FLUID, MATERIAL_SOLID, SimParams, make_particles, pad_count,
    resolve_device)


@dataclasses.dataclass
class SceneObjects:
    """Host-side object registry (reference object_collection + meshes)."""
    object_collection: dict          # object_id -> scene dict (with particleNum)
    rigid_body_ids: tuple            # object ids of mesh rigid bodies
    meshes: dict                     # object_id -> geometry.TriMesh (for OBJ export)
    rest_positions: dict             # object_id -> (V,3) mesh rest vertices
    rest_centers: dict               # object_id -> (3,) mesh rest center of mass


def _cube_lattice(lower_corner, cube_size, diameter, dim):
    """np.arange lattice identical to reference add_cube (:469-483)."""
    axes = [np.arange(lower_corner[i], lower_corner[i] + cube_size[i], diameter)
            for i in range(dim)]
    num = reduce(lambda a, b: a * b, [len(ax) for ax in axes])
    pos = np.array(np.meshgrid(*axes, sparse=False, indexing="ij"),
                   dtype=np.float32)
    pos = pos.reshape(dim, -1).transpose()
    return pos, num


def compute_cube_particle_num(start, end, diameter, dim):
    """Reference compute_cube_particle_num (:450-456): arange on raw
    start/end (pre-translation, pre-scale)."""
    return reduce(lambda a, b: a * b,
                  [len(np.arange(start[i], end[i], diameter))
                   for i in range(dim)])


def build_scene(config: SimConfig, scene_dir=".", neighbor_cap=None,
                cell_cap=None, device=None):
    """Build the padded particle store and static params from a scene config.

    device: where the particles live; None means the CUDA device, and
    without one only ``device="cpu"`` runs (state.resolve_device).

    scene_dir: directory that geometryFile paths are relative to (the
    reference resolves them against the CWD; we resolve against the scene
    root so the CLI works from anywhere).
    """
    device = resolve_device(device)
    domain_start = tuple(float(v) for v in (config.get_cfg("domainStart") or (0., 0., 0.)))
    domain_end = tuple(float(v) for v in config.get_cfg("domainEnd"))
    dim = len(domain_end)
    assert dim > 1

    particle_radius = float(config.get_cfg("particleRadius") or 0.01)
    diameter = 2.0 * particle_radius
    m_v0 = 0.8 * diameter ** dim
    density0 = float(config.get_cfg("density0") or 1000.0)
    method = int(config.get_cfg("simulationMethod") or 0)
    gravity = tuple(float(g) for g in (config.get_cfg("gravitation")
                                       or ((0., -9.81, 0.) if dim == 3 else (0., -9.81))))
    dt0 = float(config.get_cfg("timeStepSize") or 1e-4)
    stiffness = float(config.get_cfg("stiffness") or 50000.0)
    exponent = float(config.get_cfg("exponent") or 7.0)

    object_collection = {}
    rigid_body_ids = []
    dynamic_rigid_ids = []
    meshes, rest_positions, rest_centers = {}, {}, {}

    chunks = []  # list of per-object dicts of numpy arrays

    def add_chunk(object_id, pos, vel, density, pressure, material,
                  is_dynamic, color):
        n = pos.shape[0]
        chunks.append(dict(
            object_id=np.full(n, object_id, np.int32),
            x=pos.astype(np.float32),
            v=vel.astype(np.float32),
            density=density.astype(np.float32),
            pressure=pressure.astype(np.float32),
            material=np.full(n, material, np.int32),
            is_dynamic=np.full(n, is_dynamic, np.int32),
            color=color.astype(np.int32),
            m_V=np.full(n, m_v0, np.float32),
            m=(m_v0 * density).astype(np.float32),
        ))

    def add_cube(object_id, lower_corner, cube_size, material, is_dynamic,
                 color=(0, 0, 0), density=None, velocity=None):
        # reference add_cube (particle_system.py:458-495)
        pos, n = _cube_lattice(lower_corner, cube_size, diameter, dim)
        vel = (np.zeros_like(pos) if velocity is None
               else np.tile(np.asarray(velocity, np.float32), (n, 1)))
        dens = np.full(n, density if density is not None else 1000.0, np.float32)
        pres = np.zeros(n, np.float32)
        col = np.tile(np.asarray(color, np.int32), (n, 1))
        add_chunk(object_id, pos, vel, dens, pres, material, is_dynamic, col)
        return n

    # ---- Fluid blocks (reference :151-167) ----
    fluid_particle_num = 0
    for fluid in config.get_fluid_blocks():
        obj_id = fluid["objectId"]
        offset = np.array(fluid["translation"])
        start = np.array(fluid["start"]) + offset
        end = np.array(fluid["end"]) + offset
        scale = np.array(fluid["scale"])
        n = add_cube(obj_id, start, (end - start) * scale,
                     material=MATERIAL_FLUID,
                     is_dynamic=1,  # fluid is forced dynamic (:165)
                     color=fluid["color"], density=fluid["density"],
                     velocity=fluid["velocity"])
        fluid = dict(fluid)
        fluid["particleNum"] = n
        object_collection[obj_id] = fluid
        fluid_particle_num += n

    # ---- Rigid blocks (reference :171-188) ----
    solid_particle_num = 0
    for rigid in config.get_rigid_blocks():
        obj_id = rigid["objectId"]
        offset = np.array(rigid["translation"])
        start = np.array(rigid["start"]) + offset
        end = np.array(rigid["end"]) + offset
        scale = np.array(rigid["scale"])
        n = add_cube(obj_id, start, (end - start) * scale,
                     material=MATERIAL_SOLID,
                     is_dynamic=int(rigid["isDynamic"]),
                     color=rigid["color"], density=rigid["density"],
                     velocity=rigid["velocity"])
        rigid = dict(rigid)
        rigid["particleNum"] = n
        object_collection[obj_id] = rigid
        rigid_body_ids.append(obj_id)
        if rigid["isDynamic"]:
            dynamic_rigid_ids.append(obj_id)
        solid_particle_num += n

    # ---- Rigid mesh bodies (reference :191-211 + load_rigid_body :421-447) ----
    for body in config.get_rigid_bodies():
        from sph_taichi_torch.geometry import load_rigid_body_points
        obj_id = body["objectId"]
        points, mesh = load_rigid_body_points(body, diameter, scene_dir)
        n = points.shape[0]
        is_dyn = int(bool(body["isDynamic"]))
        vel = (np.tile(np.asarray(body["velocity"], np.float32), (n, 1))
               if is_dyn else np.zeros((n, dim), np.float32))
        dens = np.full(n, body["density"], np.float32)
        col = np.tile(np.asarray(body["color"], np.int32), (n, 1))
        add_chunk(obj_id, points, vel, dens, np.zeros(n, np.float32),
                  MATERIAL_SOLID, is_dyn, col)
        body = dict(body)
        body["particleNum"] = n
        object_collection[obj_id] = body
        rigid_body_ids.append(obj_id)
        if is_dyn:
            dynamic_rigid_ids.append(obj_id)
        solid_particle_num += n
        meshes[obj_id] = mesh
        rest_positions[obj_id] = mesh.vertices.copy()
        rest_centers[obj_id] = mesh.vertices.mean(axis=0)

    n_total = fluid_particle_num + solid_particle_num
    if n_total == 0:
        raise ValueError("scene contains no particles")
    np_arrays = {k: np.concatenate([c[k] for c in chunks], axis=0)
                 for k in chunks[0]}

    num_objects = max(object_collection.keys()) + 1 if object_collection else 0
    n_pad = pad_count(n_total)

    params = SimParams(
        dim=dim,
        particle_radius=particle_radius,
        density0=density0,
        gravity=gravity,
        dt0=dt0,
        stiffness=stiffness,
        exponent=exponent,
        simulation_method=method,
        domain_start=domain_start,
        domain_end=domain_end,
        n_particles=n_total,
        n_fluid=fluid_particle_num,
        n_solid=solid_particle_num,
        n_pad=n_pad,
        num_objects=num_objects,
        rigid_body_ids=tuple(rigid_body_ids),
        dynamic_rigid_ids=tuple(dynamic_rigid_ids),
        neighbor_cap=int(neighbor_cap or config.get_tpu_cfg("neighborCap", 64)),
        cell_cap=int(cell_cap or config.get_tpu_cfg("cellCap", 32)),
    )

    # per-object constant tables (see SimParams.obj_material): build only
    # when every object id is single-valued over (material, density,
    # is_dynamic) — else leave empty (fields ride the sort as before)
    obj_mat = np.full(max(num_objects, 1), MATERIAL_FLUID, np.int32)
    obj_den = np.zeros(max(num_objects, 1), np.float32)
    obj_dyn = np.zeros(max(num_objects, 1), np.int32)
    obj_m = np.zeros(max(num_objects, 1), np.float32)
    consistent = num_objects > 0
    seen = {}
    for c in chunks:
        oid = int(c["object_id"][0])
        key = (int(c["material"][0]), float(c["density"][0]),
               int(c["is_dynamic"][0]), float(c["m"][0]))
        if not (c["material"] == key[0]).all() \
                or not (c["density"] == key[1]).all() \
                or not (c["is_dynamic"] == key[2]).all() \
                or not (c["m"] == key[3]).all() \
                or seen.setdefault(oid, key) != key:
            consistent = False
            break
        obj_mat[oid], obj_den[oid], obj_dyn[oid], obj_m[oid] = key
    if consistent:
        params = dataclasses.replace(
            params,
            obj_material=tuple(int(v) for v in obj_mat),
            obj_density0=tuple(float(v) for v in obj_den),
            obj_is_dynamic=tuple(int(v) for v in obj_dyn),
            obj_m0=tuple(float(v) for v in obj_m))

    warm = bool(config.get_tpu_cfg("dfsphWarmStart", False)) and method == 4
    if warm:
        params = dataclasses.replace(params, dfsph_warm_start=True)
    particles = make_particles(np_arrays, n_pad, device,
                               with_dfsph=(method in (2, 4)),
                               with_warm=warm)
    objects = SceneObjects(object_collection=object_collection,
                           rigid_body_ids=tuple(rigid_body_ids),
                           meshes=meshes, rest_positions=rest_positions,
                           rest_centers=rest_centers)
    return params, particles, objects
