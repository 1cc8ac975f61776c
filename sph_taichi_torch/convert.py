"""Carry particle state between this package and numpy.

The leaves of the JAX package's ``Particles`` and ``SimState``, as numpy
arrays, map one to one onto this package's tuples, so the same state can
be fed to both (the parity tests do): every solver's fields, the DFSPH
extras and the pressure that an IISPH state carries from step to step (its
warm start) included.  The legacy 2D engine's ``State2D`` carries the same
way (``state2d_from_numpy`` / ``state2d_to_numpy``), every field with n
and dt, and a JAX ``ShardedSolver``'s global arrays split into the port's
per-rank slabs (``sharded_segments_from_numpy`` / ``..._to_numpy``).
Nothing here imports the JAX package: the callers pass plain dicts of
arrays.
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


_INT_FIELDS_2D = ("material", "color")

# One step of the legacy 2D engine from one shared state, taken twice with
# the pair sums in another order, agrees per field to ``rtol`` of the
# field's largest live magnitude and in the density to ``density_atol``
# kg/m^3 (``state2d_step_tolerances``).  As (rtol, density_atol):
# - JAX_STEP_TOL, the port against the JAX package on the CPU (XLA fuses
#   multiply-adds and sums in its own order): the largest share measured in
#   tests/test_torch_legacy2d.py's states is 5.4e-7 (DFSPH's alpha), the
#   largest density gap 1.83e-4 (3 ulps below 1024 kg/m^3);
# - DEVICE_STEP_TOL, the card against the CPU after the driver scene's
#   emission: DFSPH's density solve divides its velocity correction by
#   dt ~ 4e-4 s, and v_new's gap on an H100 was 3.6e-6 of its largest
#   value; chip_smoke.py measures both f32 steps from an f64 step of the
#   same state and holds each to this tolerance too.
JAX_STEP_TOL = (1e-6, 2.5e-4)
DEVICE_STEP_TOL = (1e-5, 5e-4)


def state2d_from_numpy(arrays, device, dtype=torch.float32):
    """``State2D`` on ``device`` from a dict of numpy arrays keyed by field
    name (a JAX ``State2D``'s leaves): n goes to the host as an int, dt
    stays a 0-d tensor, the float fields take ``dtype``."""
    from sph_taichi_torch.legacy2d import State2D

    fields = {}
    for name in State2D._fields:
        a = np.asarray(arrays[name])
        if name == "n":
            fields[name] = int(a)
        elif name in _INT_FIELDS_2D:
            fields[name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            fields[name] = torch.tensor(a, dtype=dtype, device=device)
    return State2D(**fields)


def state2d_to_numpy(state):
    """{field name: numpy array} of every ``State2D`` field, n as a 0-d
    int32 array (the JAX state's dtypes)."""
    out = {name: a.cpu().numpy() for name, a in state._asdict().items()
           if name != "n"}
    out["n"] = np.asarray(state.n, np.int32)
    return out


def state2d_errors(got, ref):
    """{field: largest absolute difference} between two ``State2D``s given
    as numpy dicts (every row, padding included)."""
    return {f: float(np.max(np.abs(np.asarray(got[f], np.float64)
                                   - np.asarray(ref[f], np.float64)),
                            initial=0.0))
            for f in ref}


def state2d_step_tolerances(sph, ref, it, dt, rtol, density_atol):
    """{field: absolute tolerance} for one step of the solver ``sph`` (its
    method and constants) at the incoming ``dt`` whose result ``ref``
    (numpy arrays by field) took ``it`` iterations.  Integer fields and n
    must be equal.

    WCSPH's pressure is the Tait EOS of the density: b (rho/rho0)^7 with
    b = rho0 c0^2 / gamma = 5.71e6 Pa, so a density off by density_atol
    moves it by b gamma / rho0 (rho_max/rho0)^6 density_atol (20 Pa near
    rho0 at 5e-4 kg/m^3, 10 Pa at 2.5e-4).  PCISPH's pressure adds
    s_f rho_err once per iteration, and rho_err = rho + dt d_rho - rho0
    rounds at the density's ulp: s_f it density_atol."""
    from sph_taichi_torch.legacy2d import METHOD_PCISPH, METHOD_WCSPH

    n = int(ref["n"])
    tol = {"n": 0.0, "material": 0.0, "color": 0.0, "density": density_atol}
    for f in ("x", "v", "v_new", "pressure", "pressure_acc", "d_v", "alpha",
              "dt"):
        a = np.asarray(ref[f], np.float64)
        live = a if f == "dt" else a[:n]
        tol[f] = rtol * (float(np.abs(live).max()) if live.size else 0.0)
    if sph.method == METHOD_WCSPH:
        rho = np.asarray(ref["density"], np.float64)[:n]
        rho_max = max(float(rho.max()) if rho.size else 0.0, sph.rho_0)
        b = sph.rho_0 * sph.c_0 ** 2 / sph.gamma
        tol["pressure"] += (b * sph.gamma / sph.rho_0
                            * (rho_max / sph.rho_0) ** (sph.gamma - 1)
                            * density_atol)
    elif sph.method == METHOD_PCISPH:
        c = float(dt) * sph.m / sph.rho_0
        s_f = 1.0 / max(2.0 * c * c * sph.s_f_base, 1e-6)
        tol["pressure"] += s_f * max(int(it), 1) * density_atol
    return tol


def state2d_f64_witness(sph, got, ref, ref64, it, dt):
    """How far two f32 results of one step, ``got`` (under test) and
    ``ref``, lie from the same step taken in f64 (``ref64``; numpy dicts):
    ({float field: (|got - ref64|, |ref - ref64|)}, {the fields where
    ``got`` lies more than twice as far as ``ref`` plus JAX_STEP_TOL's
    share}).  Two f32 steps that differ only in the order of their sums lie
    about equally far from the f64 one, on either side of it; a wrong one
    lies further."""
    tol = state2d_step_tolerances(sph, ref64, it, dt, *JAX_STEP_TOL)
    d_got, d_ref = state2d_errors(got, ref64), state2d_errors(ref, ref64)
    far = {k: (d_got[k], d_ref[k]) for k in ref64
           if k not in ("n",) + _INT_FIELDS_2D}
    worse = {k: v for k, v in far.items() if v[0] > 2.0 * v[1] + tol[k]}
    return far, worse


def sharded_segments_from_numpy(arrays, world, device):
    """Per-rank ``Particles`` on ``device`` from a JAX ``ShardedSolver``'s
    global particle arrays (a dict of numpy arrays by field, world * n_ext
    rows, rank d's slab in rows d * n_ext .. (d + 1) * n_ext): a list of
    ``world`` slabs, the rows of parallel/sharding.py ``ShardedSolver``'s
    states, ghost rows tagged ``is_dynamic = -1`` in both."""
    n = len(next(iter(arrays.values())))
    if n % world:
        raise ValueError(f"{n} rows do not split into {world} slabs")
    seg = n // world
    return [particles_from_numpy(
        {k: None if a is None else np.asarray(a)[d * seg:(d + 1) * seg]
         for k, a in arrays.items()}, device) for d in range(world)]


def sharded_segments_to_numpy(slabs):
    """The JAX ``ShardedSolver``'s global arrays (a dict by field) from the
    per-rank ``Particles`` (or numpy dicts) of a sharded run, rank after
    rank."""
    dicts = [s if isinstance(s, dict) else particles_to_numpy(s)
             for s in slabs]
    return {k: np.concatenate([d[k] for d in dicts]) for k in dicts[0]}
