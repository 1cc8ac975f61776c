"""High-level Simulation wrapper: scene -> solver -> frames -> exports.

Counterpart of sph_taichi_tpu/simulation.py: the reference's
run_simulation.py main loop (run_simulation.py:18-118) without the GGUI
window.  Frames advance ``numberOfStepsPerRenderUpdate`` steps and are
exported headlessly (PNG splat render / PLY particle series / OBJ
shape-matched meshes) at the reference cadence ``int(0.016 / dt)``.
Fatal flags are read from the device once per frame.  ``run`` can write
``output_dir/checkpoint.npz`` every N frames, and ``resume`` continues
from such a file (utils/checkpoint.py, the JAX package's layout).
``backend`` overrides the scene's pair engine (ops/pairs.py make_engine),
as the JAX package's Simulation does.
"""

import dataclasses
import os

import numpy as np
import torch

from sph_taichi_torch import build_scene, build_solver
from sph_taichi_torch.config import SimConfig
from sph_taichi_torch.utils import exporters
from sph_taichi_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sph_taichi_torch.utils.profiling import FATAL_KEYS, check_overflow

ITER_KEYS = ("divergence_iters", "pressure_iters")
HOST_READ_KEYS = ("divergence_host_reads", "pressure_host_reads")


class Simulation:
    def __init__(self, scene_path=None, config=None, scene_dir=None,
                 output_dir=None, device=None, backend=None):
        self.config = config or SimConfig(scene_path)
        if scene_dir is None:
            scene_dir = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(scene_path)))) \
                if scene_path else "."
        self.scene_name = (os.path.basename(scene_path).split(".")[0]
                           if scene_path else "scene")
        self.params, particles, self.objects = build_scene(
            self.config, scene_dir=scene_dir, device=device)
        # per-object palette in creation order: device-side color is not
        # permuted by the per-step sort, so the host rebuilds colors from
        # object_id
        oid0 = particles.object_id.cpu().numpy()
        col0 = particles.color.cpu().numpy()
        n_obj = int(oid0.max()) + 1 if oid0.size else 1
        self._palette = np.zeros((n_obj + 1, 3), np.int32)
        for o in np.unique(oid0):
            if o >= 0:
                self._palette[int(o)] = col0[oid0 == o][0]
        if backend:
            self.params = dataclasses.replace(self.params, backend=backend)
        self.solver = build_solver(self.params, device=particles.x.device)
        self.state = self.solver.initialize(particles)
        self.metrics = None
        self.solver_stats = {}
        self.frame = 0
        self.export_count = 0

        self.substeps = int(self.config.get_cfg(
            "numberOfStepsPerRenderUpdate") or 1)
        self.output_frames = bool(self.config.get_cfg("exportFrame"))
        self.output_ply = bool(self.config.get_cfg("exportPly"))
        self.output_obj = bool(self.config.get_cfg("exportObj"))
        dt = float(self.config.get_cfg("timeStepSize"))
        self.output_interval = max(int(0.016 / dt), 1)
        self.output_dir = output_dir or f"{self.scene_name}_output"
        self.invisible_objects = self.config.get_cfg("invisibleObjects") or []
        self.camera = exporters.Camera()

    # ------------------------------------------------------------------
    def run_frame(self):
        """``substeps`` solver steps; the fatal flags of every step are
        folded on the device and read once."""
        flags = {}
        for _ in range(self.substeps):
            self.state, self.metrics = self.solver.step(self.state)
            for k in FATAL_KEYS:
                if k in self.metrics:
                    f = self.metrics[k].to(torch.int32)
                    flags[k] = f if k not in flags else flags[k] | f
            self._fold_solver_stats(self.metrics)
        self.frame += 1
        check_overflow(flags, where=f"frame {self.frame}")

    def _fold_solver_stats(self, metrics):
        st = self.solver_stats
        st["steps"] = st.get("steps", 0) + 1
        for k in ITER_KEYS:
            if k in metrics:
                it = metrics[k].to(torch.int64)
                st[f"{k}_sum"] = st.get(f"{k}_sum", 0) + it
                st[f"{k}_max"] = torch.maximum(st.get(f"{k}_max", it), it)
        for k in HOST_READ_KEYS:
            if k in metrics:
                st[k] = st.get(k, 0) + metrics[k]

    def reset_solver_stats(self):
        self.solver_stats = {}

    def read_solver_stats(self):
        """{name: number} of ``solver_stats`` in one device read: per
        solve, the iteration sum and maximum, and the Jacobi host reads,
        over the steps since the last reset."""
        st = self.solver_stats
        dev = [k for k, v in st.items() if torch.is_tensor(v)]
        vals = torch.stack([st[k] for k in dev]).tolist() if dev else []
        out = {k: v for k, v in st.items() if not torch.is_tensor(v)}
        out.update(zip(dev, vals))
        return out

    def run(self, n_frames, export=True, checkpoint_interval=0,
            progress=False):
        for _ in range(n_frames):
            self.run_frame()
            if export and (self.frame - 1) % self.output_interval == 0:
                self.export_frame()
                self.export_count += 1
            if checkpoint_interval and self.frame % checkpoint_interval == 0:
                self.save(os.path.join(self.output_dir, "checkpoint.npz"))
            if progress:
                print(f"frame {self.frame}", flush=True)

    # ------------------------------------------------------------------
    def dump(self, obj_id):
        """{'position','velocity'} for one object
        (ParticleSystem.dump, particle_system.py:409-418)."""
        p = self.state.p
        mask = p.object_id.cpu().numpy() == obj_id
        return {"position": p.x.cpu().numpy()[mask],
                "velocity": p.v.cpu().numpy()[mask]}

    def visible_particles(self):
        p = self.state.p
        obj = p.object_id.cpu().numpy()
        mask = p.material.cpu().numpy() >= 0
        for inv in self.invisible_objects:
            mask &= obj != inv
        colors = self._palette[np.clip(obj[mask], 0, len(self._palette) - 1)]
        return (p.x.cpu().numpy()[mask],
                np.clip(colors, 0, 255).astype(np.uint8))

    # ------------------------------------------------------------------
    def export_frame(self):
        cnt = self.frame - 1
        k = self.export_count
        if self.output_frames:
            pos, col = self.visible_particles()
            exporters.render_png(
                os.path.join(f"{self.scene_name}_output_img",
                             f"{cnt:06}.png"),
                pos, col, camera=self.camera)
        if self.output_ply:
            obj_data = self.dump(obj_id=0)
            exporters.write_ply_ascii(
                exporters.ply_series_path(
                    os.path.join(self.output_dir, "particle_object_0.ply"),
                    k),
                obj_data["position"])
        if self.output_obj:
            self._export_objs(k)

    def _export_objs(self, k):
        """Shape-matched OBJ per dynamic rigid body (run_simulation.py:108-112
        + sph_base.py:253-257), from the last step's rotations."""
        if self.metrics is None:
            return
        rot = self.metrics["rigid"]["R"].cpu().numpy()
        cm = self.metrics["rigid"]["cm"].cpu().numpy()
        for i, obj_id in enumerate(self.params.dynamic_rigid_ids):
            mesh = self.objects.meshes.get(obj_id)
            if mesh is None:
                continue
            verts = exporters.shape_matched_vertices(
                self.objects.rest_positions[obj_id],
                self.objects.rest_centers[obj_id], rot[i], cm[i])
            out = mesh.copy()
            out.vertices = verts
            exporters.write_obj(
                os.path.join(self.output_dir, f"obj_{obj_id}_{k:06}.obj"),
                out)

    # ------------------------------------------------------------------
    def save(self, path):
        save_checkpoint(path, self.state)

    def resume(self, path):
        self.state = load_checkpoint(path, self.state)
