"""Pair-interaction traversal: the plain PyTorch engine and ``make_engine``.

Counterpart of ``sph_taichi_tpu/ops/pairs.py``.  A solver writes each pair
sum as a term function over (centre fields, neighbour fields, pair
geometry); the engine evaluates

    out[name][i] = sum_j term(f_i, f_j, d2, rn, dots)[name]
                   over j != i with |x_i - x_j|^2 < support_radius^2

with the ``mode="mxu"`` contract of the JAX package: outputs are "scalar"
or "radial" (coef * r_ij), ``dots[u]`` = (u_i - u_j) . r_ij for each name
in ``pair_dots``, and ``dots["_inv"]`` = 1/|r_ij|.  Values of padding rows
are undefined; callers mask them.

``GatherEngine`` gathers fields through (N, K) neighbour lists; it is the
CPU path and the plain version the CUDA kernels (ops/cuda_pairs.py) are
held against.  ``make_engine`` picks the engine of ``params.backend`` for
the device: the CUDA engines on a CUDA device, their plain versions on the
CPU.
"""

from typing import Callable, Dict

import torch

from sph_taichi_torch.ops.neighbors import build_neighbor_list


def sqrt32(a):
    """Correctly rounded f32 sqrt on every device (torch's CPU sqrt may be
    an ulp off; the CUDA kernels use IEEE sqrtf)."""
    return torch.sqrt(a.double()).float()


def div_exact(num, den):
    """num / den rounded once.  torch computes python-scalar / tensor as
    reciprocal-then-multiply, and on CUDA tensor / python-scalar too; the
    JAX package (and the reference) divide."""
    if not torch.is_tensor(num):
        return torch.full_like(den, num) / den
    return num / torch.full((), den, dtype=num.dtype, device=num.device)


def pair_geometry(d2_raw):
    """(d2, rn, inv) from the raw squared distance, rounded as the gather
    oracle pinned the goldens: rn = sqrt(sum), d2 = rn*rn,
    inv = 1/sqrt(max(d2, 1e-38))."""
    rn = sqrt32(d2_raw)
    d2 = rn * rn
    inv = torch.ones_like(d2) / sqrt32(torch.clamp_min(d2, 1e-38))
    return d2, rn, inv


class GatherEngine:
    """(N, K) neighbour-list engine in plain PyTorch."""

    fused = False   # forces return accelerations; advect and clamp follow

    def __init__(self, params):
        self.params = params

    def prepare(self, x, cell_starts):
        params = self.params
        return build_neighbor_list(
            x, cell_starts, params.grid_num, params.grid_size,
            params.support_radius, params.neighbor_cap, params.cell_cap,
            dim=params.dim, x_origin=params.x_origin)

    def diag(self, nl):
        return nl.diag

    def traverse(self, nl, x, fields: Dict[str, torch.Tensor],
                 term_fn: Callable, out_specs: Dict[str, str],
                 pair_dots=()):
        idx = nl.idx
        fi = {k: v[:, None] for k, v in fields.items()}
        fj = {k: v[idx] for k, v in fields.items()}
        rvec = tuple(x[:, None, d] - x[:, d][idx] for d in range(3))
        d2, rn, inv = pair_geometry(
            rvec[0] * rvec[0] + rvec[1] * rvec[1] + rvec[2] * rvec[2])
        valid = nl.mask()
        dots = {"_inv": inv}
        for u in pair_dots:
            du = [fi[f"{u}{d}"] - fj[f"{u}{d}"] for d in range(3)]
            dots[u] = du[0] * rvec[0] + du[1] * rvec[1] + du[2] * rvec[2]
        contribs = term_fn(fi, fj, d2, rn, dots)
        outs = {}
        for name, spec in out_specs.items():
            c = torch.broadcast_to(contribs[name], valid.shape)
            c = torch.where(valid, c, torch.zeros_like(c))
            if spec == "radial":
                outs[name] = tuple(sum_in_order(
                    torch.stack([c * rv for rv in rvec])).unbind(0))
            else:
                outs[name] = sum_in_order(c)
        return outs


def sum_in_order(c):
    """Sums of ``c`` (..., K) over its last axis, adding the columns left to
    right from 0, as each CUDA kernel adds its pairs in neighbour-list
    order: the kernel and its plain version then round every sum alike.
    (``torch.sum`` reduces in an order of its own, a few ulps away, which a
    cancelling sum such as viscosity near a splash magnifies past the
    tolerance.)"""
    cols = c.movedim(-1, 0).contiguous()
    out = torch.zeros_like(cols[0])
    for col in cols:
        out = out + col
    return out


BACKENDS = ("auto", "gather", "pallas_blocks", "pallas_slots")


def make_engine(params, device):
    """The pair engine of ``params.backend`` on ``device``, with the JAX
    command line's names (run_simulation.py --backend):

    - ``auto`` and ``pallas_blocks``: the cell-run CUDA engine on a CUDA
      device, ``GatherEngine`` on the CPU;
    - ``pallas_slots``: the slot CUDA engine on a CUDA device, the plain
      slot engine (ops/slots.py) on the CPU;
    - ``gather``: ``GatherEngine`` on the CPU.  On a CUDA device it
      raises: the plain engines are oracles, never a path on the card.
    """
    device = torch.device(device)
    backend = params.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no pair engine for device {device}")
    cuda = device.type == "cuda"
    if backend == "gather" and cuda:
        raise ValueError(
            "backend 'gather' is the plain engine, the CPU path the CUDA "
            "kernels are held against; on a CUDA device use 'auto', "
            "'pallas_blocks' or 'pallas_slots'")
    if backend == "pallas_slots":
        if cuda:
            from sph_taichi_torch.ops.cuda_pairs import CudaSlotEngine
            return CudaSlotEngine(params)
        from sph_taichi_torch.ops.slots import SlotGatherEngine
        return SlotGatherEngine(params)
    if cuda:
        from sph_taichi_torch.ops.cuda_pairs import CudaEngine
        return CudaEngine(params)
    return GatherEngine(params)
