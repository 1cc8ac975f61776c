"""The communicator of a sharded run, and the launcher of its ranks.

``Comm`` is the slab decomposition's whole use of ``torch.distributed``
(parallel/sharding.py), one process per rank, each with its own device:

- ``hop(block, direction)``: the ring shift of the JAX package's
  ``lax.ppermute`` (sph_taichi_tpu/parallel/sharding.py): this rank's block
  goes to rank + direction (mod D) and the block of rank - direction comes
  back, in one ``batch_isend_irecv``.  At world size 1 it is the identity,
  as the one-device ring is (torch sends nothing to its own rank);
- ``psum`` and ``pmax``: ``all_reduce`` with SUM and MAX, every rank
  getting the same value.

Under gloo every tensor goes through host memory (``_host``, the one place
that stages): gloo's point-to-point operations are not counted on to take
CUDA tensors.  NCCL needs one device per rank; ``launch`` refuses two ranks
on one device under it rather than switching backends.  ``gather_host``
collects a picklable object from every rank (the host-side view of a
state, parallel/sharding.py ``gather_particles``), outside any step.

``launch`` spawns the ranks of a run: each process initializes its process
group from a ``file://`` store in a temporary directory with an explicit
timeout, builds its ``Comm`` and calls ``target(comm, device, *args)``, a
function of the package (spawn pickles it by reference); the ranks'
results come back through that directory.  A rank that raises or outlives
the timeout fails the launch, and every process it started is stopped.
``single`` gives a world of one rank in the calling process.
"""

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


class Comm:
    """This rank's view of the ring of ``world`` ranks.  Counts its
    collectives (``calls``) and the bytes it hopped (``hop_bytes``)."""

    def __init__(self, rank=0, world=1, backend=None):
        self.rank = rank
        self.world = world
        self.backend = backend
        self.calls = 0
        self.hop_bytes = 0

    def reset_counts(self):
        self.calls = 0
        self.hop_bytes = 0

    def _host(self, t):
        """The tensor a collective is given: a host copy under gloo."""
        return t.cpu() if self.backend == "gloo" else t

    def hop(self, block, direction):
        """The block of rank - direction (mod world), given this rank's."""
        if self.world == 1:
            return block
        self.calls += 1
        self.hop_bytes += block.numel() * block.element_size()
        send = self._host(block.contiguous())
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          (self.rank + direction) % self.world),
               dist.P2POp(dist.irecv, recv,
                          (self.rank - direction) % self.world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(block.device)

    def _all_reduce(self, t, op):
        if self.world == 1:
            return t
        self.calls += 1
        buf = self._host(t).clone()
        dist.all_reduce(buf, op=op)
        return buf.to(t.device)

    def psum(self, t):
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t):
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def gather_host(self, obj):
        """[obj of rank 0, ..., obj of rank world - 1] on every rank."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


@contextlib.contextmanager
def single(backend="gloo", timeout=300.0):
    """A ``Comm`` of world size 1 over a process group of this process
    (``file://`` store in a temporary directory), destroyed on exit."""
    tmp = tempfile.mkdtemp(prefix="sph_rank_")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            yield Comm(0, 1, backend)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, world, backend, devices, store, timeout_s, target,
               args):
    """The body of one spawned rank (see ``launch``): one torch thread, as
    the ranks of a run share the host's cores."""
    result_path = os.path.join(os.path.dirname(store), f"rank{rank}.pkl")
    try:
        torch.set_num_threads(1)
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = ("ok", target(Comm(rank, world, backend), device, *args))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:   # reported to the launcher, which raises
        out = ("error", traceback.format_exc())
    with open(result_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(result_path + ".tmp", result_path)


def _read_result(tmp, rank):
    """("ok", result) or ("error", traceback) of a rank that has ended in
    the launch directory ``tmp``, else None."""
    path = os.path.join(tmp, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def cuda_devices(world):
    """One CUDA device name per rank, round-robin over the visible cards.
    Raises without a card, as ``state.resolve_device`` does: the CPU runs
    only where the caller names it."""
    if not (torch.cuda.is_available() and torch.cuda.device_count()):
        raise RuntimeError(
            "sph_taichi_torch runs its ranks on CUDA devices by default and "
            "none is available; pass devices=['cpu'] * world to run them on "
            "the CPU")
    count = torch.cuda.device_count()
    return [f"cuda:{r % count}" for r in range(world)]


def launch(target, world, args=(), backend="gloo", devices=None,
           timeout=300.0):
    """[target(comm, device, *args) of each rank] over ``world`` spawned
    processes.  ``devices``: one device name per rank; None gives each rank
    a CUDA device, round-robin over the cards (``cuda_devices``, which
    raises without one: pass ``["cpu"] * world`` for the CPU).  NCCL
    refuses two ranks on one device.  ``timeout`` (seconds) bounds the
    process group's collectives and the whole launch."""
    import multiprocessing as mp

    devices = list(cuda_devices(world) if devices is None else devices)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend == "nccl" and len(set(devices)) < world:
        raise ValueError(f"NCCL runs one rank per device; {world} ranks "
                         f"on {sorted(set(devices))}")
    tmp = tempfile.mkdtemp(prefix="sph_ranks_")
    store = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, devices, store, timeout,
                               target, args), daemon=True)
             for r in range(world)]
    try:
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        outs = [None] * world
        # a rank that fails stops the run at once: the others would wait
        # in their next collective until the timeout
        while any(o is None for o in outs):
            for r in range(world):
                if outs[r] is not None:
                    continue
                dead = not procs[r].is_alive()
                outs[r] = _read_result(tmp, r)
                if outs[r] is None and dead:
                    outs[r] = ("error", f"exited with code "
                               f"{procs[r].exitcode} and no result")
            errors = [f"rank {r}: {o[1]}" for r, o in enumerate(outs)
                      if o is not None and o[0] == "error"]
            if errors:
                raise RuntimeError("sharded run failed:\n"
                                   + "\n".join(errors))
            if time.monotonic() > deadline:
                late = [r for r, o in enumerate(outs) if o is None]
                raise TimeoutError(f"ranks {late} of {world} still running "
                                   f"after {timeout} s")
            time.sleep(0.05)
        return [o[1] for o in outs]
    finally:
        for proc in procs:
            if proc.pid is None:
                continue        # never started
            if proc.is_alive():
                proc.kill()
            proc.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
