"""The step-start pair list of PCISPH's and IISPH's loops and WCSPH's step.

A loop whose pair set stays that of the step start walks the same
candidates and accepts the same pairs in every iteration: PCISPH's (its
terms at the predicted positions over the step-start pairs) and IISPH's
(its positions do not move from the sort to the advect).  Over the cell
runs a kernel (``pcisph_step_pairs``, ``iisph_step_pairs``;
csrc/pair_common.cuh ``build_pair_list``) runs the candidate phase of the
two-phase walk once per step and writes each centre's accepted neighbours,
in the walk's order, to a fixed-stride list in device memory (``PairList``,
the loop's context); the loop kernels run only the pair body over it.  A
warp holding a centre with more than ``PAIR_LIST_ENTRIES`` accepted pairs
walks the cells in one phase inside the kernel (the same pairs, in the same
order).  Over the cell runs the loop wrappers take only the list, not bare
cell offsets.  The slot walk reads its map and no list.  WCSPH's step has
no loop, but its positions too stay the sort's until the force kernel's
advect: its density kernel writes the list while it sums
(ops/cuda_pairs.py ``density_sum_list``) and its force kernel reads it.
DFSPH's step does the same from its density-and-factor kernel to its
non-pressure kernel (ops/cuda_dfsph.py ``density_factor_list``), and
PCISPH's non-pressure kernel reads the loop's list.

The centres a list serves: PCISPH's loop and both steps' non-pressure
kernel walk the fluid centres (``"fluid"``), as DFSPH's list does;
IISPH's every real centre (``"real"``), solids included, because its A
reads the solids' pressure accelerations; WCSPH's density lists every
real centre too.

``step_pairs_plain`` is the list from the plain engine's neighbour lists;
on CPU tensors the loop's context is those lists themselves, which the
plain versions read.
"""

from typing import NamedTuple

import torch

from sph_taichi_torch.ops.cuda_pairs import (
    _check, _plain_ctx, _raise_on, _stream, _walk, pair_consts)
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.slots import SlotMap

# mirror of csrc/pair_common.cuh kPairListEntries (checked when a library
# loads): the accepted pairs the step-start list holds per centre
PAIR_LIST_ENTRIES = 64


class PairList(NamedTuple):
    """A loop's context over the cell runs: the step-start cell offsets and
    pair list.  Entry k of row i's list at ``idx[k, i]``
    (i32[PAIR_LIST_ENTRIES, n_pad]), valid for k < min(cnt[i],
    PAIR_LIST_ENTRIES); ``cnt`` (i32[n_pad]) is each centre's number of
    accepted step-start pairs, also beyond the list, and 0 on rows that are
    not centres."""
    starts: torch.Tensor
    idx: torch.Tensor
    cnt: torch.Tensor


def centre_rows(p, centres):
    """bool[n]: the rows a list of ``centres`` ("fluid" or "real")
    serves."""
    if centres == "fluid":
        return p.is_fluid()
    if centres == "real":
        return p.material >= 0
    raise ValueError(f"centres: {centres!r}, expected 'fluid' or 'real'")


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


def step_pairs(launch, name, launches, ctx, p, params, buffers=None):
    """A loop's context for the sorted step-start particles ``p``: given
    their cell offsets, a ``PairList`` built by one launch of the kernel
    ``name`` (``launch()`` gives its launcher, ``<name>_launch`` of its
    library; counted in ``launches[name]``) into ``buffers`` (a dict,
    filled with the list's tensors at the first call and reused after;
    None: new tensors); given a ``SlotMap``, the map itself.  On CPU
    tensors, given cell offsets, the plain engine's neighbour lists of
    ``p``: the step-start pairs that the plain versions read
    (``step_pairs_plain`` gives them in the list's layout)."""
    if isinstance(ctx, SlotMap):
        return ctx
    if p.x.device.type == "cpu":
        return _plain_ctx(ctx, p, params)
    dev, n, ptr, _, _ = _walk(ctx, p, params)
    pairs = PairList(ctx, *list_buffers(buffers, n, dev))
    rc = launch()(
        ptr["x"], ptr["material"], ptr["starts"], pairs.idx.data_ptr(),
        pairs.cnt.data_ptr(), n, pair_consts(params), _stream(dev))
    _raise_on(rc, name)
    launches[name] += 1
    return pairs


def _refuse(ctx, solver, kind, source="step_pairs"):
    raise TypeError(f"{solver}'s list kernels take the step's context from "
                    f"{source} ({kind} or a SlotMap), not "
                    f"{type(ctx).__name__}")


def loop_walk(ctx, p, params, solver, source="step_pairs"):
    """``_walk`` of a list kernel's context, and the launcher's list
    arguments: the list of a ``PairList``, none for a ``SlotMap``; raises
    for any other context (``solver`` names the kernels and ``source`` the
    call that makes their context in the message)."""
    if isinstance(ctx, SlotMap):
        return (*_walk(ctx, p, params), (None, None))
    if not isinstance(ctx, PairList):
        _refuse(ctx, solver, "a PairList", source)
    dev, n, ptr, walk, suffix = _walk(ctx.starts, p, params)
    lst = (_check("pair list", ctx.idx, torch.int32, (PAIR_LIST_ENTRIES, n),
                  dev),
           _check("pair counts", ctx.cnt, torch.int32, (n,), dev))
    return dev, n, ptr, walk, suffix, lst


def plain_loop_ctx(ctx, p, params, solver):
    """The plain versions' neighbour lists of a loop context on CPU
    tensors: the lists ``step_pairs`` gave, or a ``SlotMap``'s slot lists;
    raises for any other context."""
    if isinstance(ctx, NeighborList):
        return ctx
    if not isinstance(ctx, SlotMap):
        _refuse(ctx, solver, "neighbour lists on CPU tensors")
    return _plain_ctx(ctx, p, params)
