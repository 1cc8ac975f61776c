"""The bundled scenes (data/scenes/*.json) in the port against the JAX
package, on the CPU.

- For each of the seven scenes, at its own size: ``build_scene`` gives the
  JAX package's counts, parameters (but the JAX package's TPU tiling
  fields and its slot layers, which it sizes for the TPU: 3 here, the
  port keeps 4, cell_cap's 32), rigid-body tables and every initial
  particle field (x, v, m, m_V, density and the rest), all bitwise: no
  field needs a tolerance.
- high_fluid_wcsph, high_fluid_dfsph and armadillo_bath_dynamic_dfsph at
  a coarse ``particleRadius`` (COARSE_RADIUS, set in the loaded scene
  dict and nothing else changed: 4,352 particles in the columns, 28,272 +
  3 x 44 solids in the armadillo bath; no radius keeps 100 solids a body
  under 30,000 particles, r = 0.03 gives 97 and 65,600): each initialized
  and stepped once by each package, index-wise at the engine tolerance
  (atol 2e-5, rtol 2e-4, conftest._assert_states_close), DFSPH's
  iteration counts equal; then one step from the JAX state at the
  column's impact on the far wall, carried across with
  ``convert.state_from_numpy``.
- At the coarse radius the padded box (padding = 4 r = 0.16 m) takes in
  the fluid blocks' outer layers (the columns start at 0.1 m, the bath at
  0.04 m), so both packages' box clamp stacks them in the first steps:
  the columns burst (fluid at the far wall by step 3 under DFSPH, ~190
  under WCSPH; DFSPH's pressure solve at its cap of 100 in step 6), and
  the armadillo bath's state is not finite from step 3, before the fluid
  reaches an armadillo, in both packages.  The cases hold those steps
  against the JAX package's (the cap and the loss of finiteness in the
  same step).  The armadillo contact is held on the same coarse scene
  with the fluid block moved inside the padded box (its one other
  change), one step from the JAX state at the first contact (a fluid
  particle within the support radius of an armadillo): the two-way
  reaction and the moving volumes.

Seconds on one worker (one torch thread, the module fixture): ~125; the
port's CPU steps at 28,272 rows take the most of it (the coarse bath's
step 3, whose divergence solve runs 83 iterations before the rigid
solve refuses its state, ~40 s).
"""

import dataclasses
import functools
import glob
import json
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import sph_taichi_tpu as J

import sph_taichi_torch as T
from sph_taichi_torch import convert

ATOL, RTOL = 2e-5, 2e-4
COARSE_RADIUS = 0.04
SCENE_FILES = sorted(glob.glob("data/scenes/*.json"))
RUN_SCENES = ("high_fluid_wcsph", "high_fluid_dfsph",
              "armadillo_bath_dynamic_dfsph")
ITER_KEYS = ("divergence_iters", "pressure_iters")
# the JAX package's TPU tiling and cap planning (scene.py), which the port
# does not carry; and slot_layers, which it sizes for the TPU
JAX_ONLY = ("slot_layers",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name(path):
    return os.path.basename(path).split(".")[0]


# ---------------------------------------------------------------------------
# build_scene on the seven scenes, at their own size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SCENE_FILES, ids=_name)
def test_build_scene_matches_jax(path):
    jp, jpart, jobj = J.build_scene(J.SimConfig(path), scene_dir=".")
    tp, tpart, tobj = T.build_scene(T.SimConfig(path), device="cpu")
    assert (tp.n_fluid, tp.n_solid, tp.n_particles, tp.n_pad) == (
        jp.n_fluid, jp.n_solid, jp.n_particles, jp.n_pad)
    jf = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    for f in dataclasses.fields(tp):
        if f.name in jf and f.name not in JAX_ONLY:
            assert str(getattr(tp, f.name)) == str(jf[f.name]), f.name
    # the rigid bodies' tables and rest shapes
    assert tobj.rigid_body_ids == jobj.rigid_body_ids
    for field in ("rest_positions", "rest_centers"):
        got, ref = getattr(tobj, field), getattr(jobj, field)
        assert sorted(got) == sorted(ref), field
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]), err_msg=field)
    ref = {k: np.asarray(v) for k, v in jpart._asdict().items()
           if v is not None}
    got = convert.particles_to_numpy(tpart)
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)


# ---------------------------------------------------------------------------
# the three scenes the card runs, at the coarse radius
# ---------------------------------------------------------------------------

def _scene(name, moved=False):
    """The scene dict at COARSE_RADIUS; ``moved``: the fluid blocks
    clipped to the padded box as well."""
    with open(f"data/scenes/{name}.json") as f:
        d = json.load(f)
    conf = d["Configuration"]
    conf["particleRadius"] = COARSE_RADIUS
    if moved:
        pad = 4 * COARSE_RADIUS
        for block in d["FluidBlocks"]:
            block["start"] = [max(s, pad) for s in block["start"]]
            block["end"] = [min(e, hi - pad) for e, hi in
                            zip(block["end"], conf["domainEnd"])]
    return d


def _np_state(s):
    return ({k: np.asarray(v) for k, v in s.p._asdict().items()
             if v is not None},
            np.asarray(s.rigid_rest_cm), np.asarray(s.dt), np.asarray(s.t),
            np.asarray(s.step_count))


def _finite(np_state):
    return bool(np.isfinite(np_state[0]["x"]).all()
                and np.isfinite(np_state[0]["v"]).all())


def _at_far_wall(params, np_state):
    p = np_state[0]
    hi = np.float32(params.domain_end[0] - params.padding)
    return bool((p["x"][p["material"] == 1][:, 0] >= hi).any())


def _in_contact(params, np_state):
    p = np_state[0]
    fluid = p["x"][p["material"] == 1]
    solid = p["x"][p["material"] == 0]
    return bool((cKDTree(solid).query(fluid, k=1)[0]
                 < params.support_radius).any())


@functools.lru_cache(maxsize=None)
def _jax_run(name, moved=False, until=None, most=1, after=0):
    """The JAX package's run of the coarse scene: (params, states after
    0..n steps as numpy, metrics of steps 1..n, the step that met
    ``until``), n the first step whose state is not finite, or ``after``
    steps past the first that meets ``until`` ("wall", "contact"), or
    ``most``."""
    d = _scene(name, moved)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=d))
    solver = J.build_solver(jp)
    state = solver.initialize(jpart)
    states, metrics, met = [_np_state(state)], [], None
    test = {"wall": _at_far_wall, "contact": _in_contact}.get(until)
    while len(metrics) < most:
        state, m = solver.step(state)
        states.append(_np_state(state))
        metrics.append({k: np.asarray(v) for k, v in m.items()
                        if k != "rigid"})
        if not _finite(states[-1]):
            break
        if met is None and test and test(jp, states[-1]):
            met = len(metrics)
        if met is not None and len(metrics) == met + after:
            break
    return jp, states, metrics, met


def _port_step(name, np_state, moved=False):
    """One step of the port's solver from a carried-over state."""
    tp = T.build_scene(T.SimConfig(config_dict=_scene(name, moved)),
                       device="cpu")[0]
    solver = T.build_solver(tp, device="cpu")
    return solver.step(convert.state_from_numpy(*np_state, "cpu"))


FIELDS = {"high_fluid_wcsph": ("x", "v", "density", "pressure", "acc"),
          "high_fluid_dfsph": ("x", "v", "acc", "density", "density_adv",
                               "dfsph_factor"),
          "armadillo_bath_dynamic_dfsph": ("x", "v", "acc", "density",
                                           "density_adv", "dfsph_factor",
                                           "m_V")}


def _assert_step(name, got_state, got_metrics, ref_state, ref_metrics):
    ref = ref_state[0]
    got = convert.particles_to_numpy(got_state.p)
    np.testing.assert_array_equal(got["material"], ref["material"])
    real = ref["material"] != -1
    for field in FIELDS[name]:
        if field == "acc":
            # a component whose pair terms cancel (across a wall, in the
            # burst) keeps a few ulps of the row's scale under the two
            # packages' sum orders: held relative to its row's largest
            # component, as tests/test_torch_iisph_compact.py holds it
            g, r = got[field][real], ref[field][real]
            bound = ATOL + RTOL * np.abs(r).max(axis=1, keepdims=True)
            bad = np.argwhere(np.abs(g - r) > bound)
            assert bad.size == 0, (f"acc: {len(bad)} components off, first "
                                   f"row {bad[0, 0]}: {g[bad[0, 0]]} vs "
                                   f"{r[bad[0, 0]]}")
            continue
        np.testing.assert_allclose(got[field][real], ref[field][real],
                                   atol=ATOL, rtol=RTOL, err_msg=field)
    for k in ITER_KEYS:
        if k in ref_metrics:
            assert int(got_metrics[k]) == int(ref_metrics[k]), k


@pytest.mark.parametrize("name", RUN_SCENES)
def test_coarse_first_step_matches_jax(name):
    """Each package builds, initializes and steps the coarse scene on its
    own: the initialized states equal bitwise (the sort), but the solids'
    m_V at rtol 2e-6 (the dense path's sum over every solid: torch and XLA
    add in different orders, an ulp apart on 61 of the 132 armadillo
    solids; tests/test_torch_boundary_volume.py's limit), the first step
    index-wise, iterations equal."""
    _, states, metrics, _ = _jax_run(name, most=10)
    tp, tpart, _ = T.build_scene(T.SimConfig(config_dict=_scene(name)),
                                 device="cpu")
    solver = T.build_solver(tp, device="cpu")
    state = solver.initialize(tpart)
    got0 = convert.particles_to_numpy(state.p)
    for k, a in states[0][0].items():
        if k == "m_V":
            np.testing.assert_allclose(got0[k], a, rtol=2e-6, atol=0)
        else:
            np.testing.assert_array_equal(got0[k], a, err_msg=k)
    state, m = solver.step(state)
    _assert_step(name, state, m, states[1], metrics[0])


@pytest.mark.parametrize("name", ("high_fluid_wcsph", "high_fluid_dfsph"))
def test_coarse_wall_impact_step_matches_jax(name):
    """The step in which the burst column's fluid first reaches the far
    wall (the box clamp there), from the JAX state before it."""
    jp, states, metrics, k = _jax_run(name, until="wall", most=400)
    assert k == len(metrics) and _finite(states[k]), k
    assert not _at_far_wall(jp, states[k - 1])
    ts, tm = _port_step(name, states[k - 1])
    _assert_step(name, ts, tm, states[k], metrics[k - 1])
    assert _at_far_wall(jp, convert.state_to_numpy(ts))


def test_coarse_dfsph_column_pressure_cap_matches_jax():
    """Step 6 of the burst DFSPH column, from the JAX state before it: the
    pressure solve runs to its cap of 100 in both packages."""
    _, states, metrics, _ = _jax_run("high_fluid_dfsph", most=6)
    assert int(metrics[5]["pressure_iters"]) == 100
    ts, tm = _port_step("high_fluid_dfsph", states[5])
    _assert_step("high_fluid_dfsph", ts, tm, states[6], metrics[5])


def test_coarse_armadillo_bath_loses_finiteness_with_jax():
    """The coarse armadillo bath: step 2 (the clamp-stacked layers burst)
    index-wise from the JAX state after step 1; step 3 from the JAX state
    after step 2, before any fluid reaches an armadillo, is not finite in
    the JAX package (its SVD of a non-finite rigid moment returns NaN),
    and the port's rigid solve refuses it (torch.linalg.svd raises on
    non-finite input)."""
    name = "armadillo_bath_dynamic_dfsph"
    jp, states, metrics, _ = _jax_run(name, most=10)
    assert len(metrics) == 3 and not _finite(states[3])
    assert _finite(states[2]) and not _in_contact(jp, states[2])
    ts, tm = _port_step(name, states[1])
    _assert_step(name, ts, tm, states[2], metrics[1])
    with pytest.raises(torch.linalg.LinAlgError, match="non-finite"):
        _port_step(name, states[2])


def test_coarse_armadillo_contact_step_matches_jax():
    """The coarse armadillo bath with its fluid block inside the padded
    box: the step after the first contact, from the JAX state there
    (dfsph_solver_dv with the reaction, the moving volumes, the rigid
    solve of three dynamic bodies)."""
    name = "armadillo_bath_dynamic_dfsph"
    jp, states, metrics, k = _jax_run(name, moved=True, until="contact",
                                      most=40, after=1)
    assert k is not None and len(metrics) == k + 1, k
    assert not _in_contact(jp, states[k - 1])
    ts, tm = _port_step(name, states[k], moved=True)
    _assert_step(name, ts, tm, states[k + 1], metrics[k])
    dynamic = convert.state_to_numpy(ts)[0]["is_dynamic"]
    assert int((dynamic[:jp.n_particles] == 1).sum()) == jp.n_particles
