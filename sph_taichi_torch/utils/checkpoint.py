"""Checkpoint / resume of a SimState (counterpart of sph_taichi_tpu/utils/checkpoint.py).

The npz layout is the JAX package's: ``leaf_{i}`` for the leaves of the
state in the order of its fields, the particle fields first, with the
``None`` fields dropped (``jax.tree_util.tree_flatten`` order).  This
package's ``Particles`` and ``SimState`` have the JAX package's fields in
the same order, so a checkpoint written by either package loads into the
other.  ``Simulation.run`` writes one every ``checkpoint_interval``
frames.
"""

import os

import numpy as np
import torch

from sph_taichi_torch.state import Particles, SimState


def _leaves(state: SimState):
    return ([a for a in state.p if a is not None]
            + [state.rigid_rest_cm, state.dt, state.t, state.step_count])


def save_checkpoint(path, state: SimState):
    """Write ``state`` to ``path`` (compressed npz) through a temporary
    file and ``os.replace``, so a reader never sees a partial file."""
    arrays = {f"leaf_{i}": a.detach().cpu().numpy()
              for i, a in enumerate(_leaves(state))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path, like: SimState) -> SimState:
    """The state in ``path``, laid out as ``like``: each leaf is checked
    against ``like``'s shape (ValueError on a mismatch), cast to its dtype
    and put on its device."""
    refs = _leaves(like)
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(refs):
            raise ValueError(f"checkpoint has {n} leaves, expected "
                             f"{len(refs)}")
        leaves = []
        for i, ref in enumerate(refs):
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {i} shape {a.shape} != "
                                 f"expected {tuple(ref.shape)}")
            leaves.append(torch.tensor(a, dtype=ref.dtype,
                                       device=ref.device))
    it = iter(leaves)
    p = Particles(*(None if a is None else next(it) for a in like.p))
    return SimState(p, *it)
