"""Carry particle state between this package and numpy.

The leaves of the JAX package's ``Particles`` and ``SimState``, as numpy
arrays, map one to one onto this package's tuples, so the same state can
be fed to both (the parity tests do): every solver's fields, the DFSPH
extras and the pressure that an IISPH state carries from step to step (its
warm start) included.  Nothing here imports the JAX package: the callers
pass plain dicts of arrays.
"""

import numpy as np
import torch

from sph_taichi_torch.state import Particles, SimState

_INT_FIELDS = ("object_id", "material", "is_dynamic", "color")


def particles_from_numpy(arrays, device):
    """Particles on ``device`` from a dict of numpy arrays keyed by field
    name; absent or None optional fields stay None."""
    fields = {}
    for name in Particles._fields:
        a = arrays.get(name)
        if a is None:
            continue
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        fields[name] = torch.tensor(np.asarray(a, dtype=dtype),
                                    device=device)
    return Particles(**fields)


def particles_to_numpy(p):
    """{field name: numpy array} of the fields that are set."""
    return {name: a.cpu().numpy() for name, a in p._asdict().items()
            if a is not None}


def state_from_numpy(particles, rigid_rest_cm, dt, t, step_count, device):
    """SimState on ``device``: ``particles`` is a dict as above, the rest
    are arrays or scalars."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return SimState(
        p=particles_from_numpy(particles, device),
        rigid_rest_cm=f32(rigid_rest_cm), dt=f32(dt), t=f32(t),
        step_count=torch.tensor(np.asarray(step_count, np.int32),
                                device=device))


def state_to_numpy(state):
    """(particles dict, rigid_rest_cm, dt, t, step_count) as numpy, the
    arguments of ``state_from_numpy`` without the device."""
    return (particles_to_numpy(state.p), state.rigid_rest_cm.cpu().numpy(),
            state.dt.cpu().numpy(), state.t.cpu().numpy(),
            state.step_count.cpu().numpy())
