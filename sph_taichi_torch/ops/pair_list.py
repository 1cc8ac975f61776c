"""The step's pair list of the WCSPH, IISPH, PCISPH and DFSPH steps.

On the WCSPH, IISPH and PCISPH steps the positions stay the sort's from the
density kernel to the advect (IISPH's kick moves v; PCISPH's loop
evaluates its terms at predicted positions over the step-start pairs), and
every later pair kernel's centres are a subset of the density kernel's
(every real row), so they all accept its pairs.  Over the cell runs the
density kernel (ops/cuda_pairs.py ``density_sum_list``;
csrc/pair_common.cuh ``build_pair_list``) runs the candidate phase of the
two-phase walk, sums the densities in it and writes each real centre's
accepted neighbours, in the walk's order, to a fixed-stride list in device
memory (``PairList``, the step's context); the later kernels (WCSPH's
forces, IISPH's four kernels, PCISPH's loop and non-pressure kernel) run
only their pair body over it, every loop iteration too.  A warp holding a
centre with more than ``PAIR_LIST_ENTRIES`` accepted pairs walks the cells
in one phase inside the kernel (the same pairs, in the same order).  Over
the slot walk the density kernel keeps its one-phase walk and writes the
same list of every real centre as it walks (a ``PairList`` whose walk is
the ``SlotMap``), and the same kernels read it, a warp over the list
walking the map in one phase.  On the card their wrappers take only that
context (``list_walk``), not bare cell offsets or a bare ``SlotMap``.
DFSPH's step does the same from its density-and-factor kernel to its
non-pressure kernel (ops/cuda_dfsph.py ``density_factor_list``), listing
the fluid centres.  Over the slot walk its density-and-factor kernel
writes a list of the fluid and dynamic-rigid centres in its one-phase
walk, and its Jacobi kernels (``jacobi_walk``) and its non-pressure kernel
(``list_walk``) read it; over the cell runs the Jacobi kernels keep their
two-phase walk.

``step_pairs_plain`` is a list from the plain engine's neighbour lists
(the plain versions of the list-writing kernels give it); on CPU tensors
the step's context is those lists themselves, which the plain versions
read.
"""

from typing import NamedTuple

import torch

from sph_taichi_torch.ops.cuda_pairs import _check, _plain_ctx, _walk
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.slots import SlotMap

# mirror of csrc/pair_common.cuh kPairListEntries (checked when a library
# loads): the accepted pairs the step's list holds per centre
PAIR_LIST_ENTRIES = 64


class PairList(NamedTuple):
    """A step's context: its walk, the cell offsets or the ``SlotMap``,
    and the step's pair list.  Entry k of row i's list at ``idx[k, i]``
    (i32[PAIR_LIST_ENTRIES, n_pad]), valid for k < min(cnt[i],
    PAIR_LIST_ENTRIES); ``cnt`` (i32[n_pad]) is each centre's number of
    accepted pairs, also beyond the list, and 0 on rows that are not
    centres."""
    walk: object
    idx: torch.Tensor
    cnt: torch.Tensor


def centre_rows(p, centres):
    """bool[n]: the rows a list of ``centres`` serves: "fluid", "real", or
    "jacobi" (the rows DFSPH's Jacobi kernels walk: fluid and dynamic
    rigid)."""
    if centres == "fluid":
        return p.is_fluid()
    if centres == "real":
        return p.material >= 0
    if centres == "jacobi":
        return p.is_fluid() | p.is_dynamic_rigid()
    raise ValueError(f"centres: {centres!r}, expected 'fluid', 'real' or "
                     f"'jacobi'")


def check_entries(lib_entries, solver):
    """Raise unless the library's kPairListEntries is PAIR_LIST_ENTRIES."""
    if lib_entries != PAIR_LIST_ENTRIES:
        raise RuntimeError(f"csrc/pair_common.cuh kPairListEntries is "
                           f"{lib_entries} in {solver}'s library, "
                           f"PAIR_LIST_ENTRIES {PAIR_LIST_ENTRIES}")


def step_pairs_plain(nl, p, centres):
    """Plain version of a list build: (idx, cnt) of ``PairList`` from the
    plain engine's neighbour lists ``nl`` of the step-start particles
    ``p``, which hold each centre's neighbours in the kernels' walk order,
    for the rows of ``centres``.  Entries past a row's listed pairs are -1.
    Raises if ``nl`` holds fewer columns than a row's listed pairs."""
    k_list = PAIR_LIST_ENTRIES
    cnt = torch.where(centre_rows(p, centres), nl.cnt, 0).to(torch.int32)
    listed = torch.clamp_max(cnt, k_list)
    cols = min(k_list, nl.idx.shape[1])
    if int(listed.max()) > cols:
        raise ValueError(f"the neighbour lists hold {cols} columns, a "
                         f"centre lists {int(listed.max())} pairs")
    idx = torch.full((k_list, p.n), -1, dtype=torch.int32,
                     device=p.x.device)
    idx[:cols] = nl.idx[:, :cols].T.to(torch.int32)
    k = torch.arange(k_list, device=p.x.device)[:, None]
    return torch.where(k < listed[None, :], idx, -1), cnt


def list_buffers(buffers, n, dev):
    """(idx, cnt) of a ``PairList`` over ``n`` rows on ``dev``: the
    tensors of the dict ``buffers``, allocated at its first call and reused
    after (None: new tensors)."""
    buffers = {} if buffers is None else buffers
    if "idx" not in buffers:
        buffers["idx"] = torch.empty((PAIR_LIST_ENTRIES, n),
                                     dtype=torch.int32, device=dev)
        buffers["cnt"] = torch.empty(n, dtype=torch.int32, device=dev)
    _check("pair list", buffers["idx"], torch.int32, (PAIR_LIST_ENTRIES, n),
           dev)
    _check("pair counts", buffers["cnt"], torch.int32, (n,), dev)
    return buffers["idx"], buffers["cnt"]


def _refuse(ctx, solver, kinds, source="density_sum_list"):
    raise TypeError(f"{solver}'s list kernels take the step's context from "
                    f"{source} ({kinds}), not {type(ctx).__name__}")


def list_walk(ctx, p, params, solver, source="density_sum_list"):
    """``_walk`` of the context of kernels that read the step's list, and
    the launcher's list arguments: the ``PairList`` that ``source`` gives,
    over the cell offsets or the ``SlotMap``.  Bare cell offsets or a bare
    ``SlotMap`` raise TypeError naming ``solver`` and ``source``: their
    kernels would have no list to read."""
    if not isinstance(ctx, PairList):
        _refuse(ctx, solver, "a PairList over the cell offsets or the "
                "slot map", source)
    dev, n, ptr, walk, suffix = _walk(ctx.walk, p, params)
    lst = (_check("pair list", ctx.idx, torch.int32, (PAIR_LIST_ENTRIES, n),
                  dev),
           _check("pair counts", ctx.cnt, torch.int32, (n,), dev))
    return dev, n, ptr, walk, suffix, lst


def jacobi_walk(ctx, p, params):
    """``list_walk`` of DFSPH's Jacobi kernels' context: over the cell
    runs bare cell offsets (the two-phase kernels, which read no list; no
    list arguments) or a ``PairList`` over them; over the slot walk the
    ``PairList`` that ``density_factor_list`` gives for a ``SlotMap`` (the
    list kernels).  A bare ``SlotMap`` raises: its kernels would have no
    list to read."""
    if isinstance(ctx, SlotMap):
        _refuse(ctx, "dfsph_divergence and dfsph_solver_dv", "a PairList "
                "over the slot map or the cell offsets", "density_factor_list")
    if isinstance(ctx, PairList):
        return list_walk(ctx, p, params, "DFSPH", "density_factor_list")
    return (*_walk(ctx, p, params), (None, None))


def plain_loop_ctx(ctx, p, params, solver):
    """The plain versions' neighbour lists of a list kernel's context on
    CPU tensors: the lists ``density_sum_list`` gave, or the slot lists of
    a ``SlotMap`` or of a ``PairList`` over one; raises for any other
    context."""
    if isinstance(ctx, NeighborList):
        return ctx
    if not isinstance(ctx, SlotMap) and not (
            isinstance(ctx, PairList) and isinstance(ctx.walk, SlotMap)):
        _refuse(ctx, solver, "neighbour lists on CPU tensors, a SlotMap or "
                "a PairList over one")
    return _plain_ctx(ctx, p, params)
