"""The port's legacy 2D engine (sph_taichi_torch/legacy2d.py) and its
driver against the JAX package's (sph_taichi_tpu/legacy2d.py).

- Counterparts of tests/test_legacy2d.py on the port: the kernel's values
  and normalization, the three methods stable through an emission at step
  4 (175 particles), the adaptive dt responding to velocity.
- ``_pci_scaling_base`` equal to the JAX one; the kernel and its
  derivative against the JAX functions under jit.
- For each method, one step from a state the JAX solver reached (after 3
  steps, and right after the emission) through ``SPHSolver2D._step`` in
  both packages: every ``State2D`` field, padding rows included, at
  ``convert.state2d_step_tolerances`` with ``JAX_STEP_TOL`` (a field to
  1e-6 of its largest live magnitude, where the largest share measured is
  5.4e-7; the density to 2.5e-4 kg/m^3, where the largest gap is 1.83e-4;
  the pressure to what that density tolerance moves it by: WCSPH's EOS
  b gamma / rho0 (rho_max/rho0)^6 x 2.5e-4, ~10 Pa; PCISPH's
  s_f x iterations x 2.5e-4), with equal iteration counts.
- For each method, 12 steps with the emission at step 4 from one shared
  start: the dt sequence to rtol 1e-6 and the final positions to 1e-6 m
  (4 ulps at 2-4 m; each step's dt follows max |v| and max |a|, so an
  ulp feeds into the next step; measured: dt 2.1e-7, x 2.4e-7 m).
- For each method, the step after the emission in f64: the port's f32
  result lies about as near it as the JAX package's (``convert.
  state2d_f64_witness``, the witness chip_smoke.py applies to the card).
- A fixed dt kept, ``add_cube`` past capacity, the default device without
  a card, the driver's PNGs on the CPU, and the modules imported with JAX
  blocked.

The shared scene is the 2D test scene of tests/test_legacy2d.py with its
block on the floor, positions and velocities jittered from a numpy seed
(capacity 256, 100 + 25 particles), so pressures, viscosity and the walls
act from the first step.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sph_taichi_tpu import legacy2d as J
from sph_taichi_torch import legacy2d as P
from sph_taichi_torch.convert import (
    JAX_STEP_TOL, state2d_errors, state2d_f64_witness, state2d_from_numpy,
    state2d_step_tolerances, state2d_to_numpy)
from sph_taichi_torch import run_simulation_2d as R


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"
STEPS, EMIT_AFTER = 12, 4
RUN_DT_RTOL, RUN_X_ATOL = 1e-6, 1e-6


def ref_kernel_2d(r, h):
    # legacy/engine/sph_solver.py:235-246
    k = 10.0 / (7.0 * np.pi * h ** 2)
    q = r / h
    if q <= 1.0:
        return k * (1 - 1.5 * q ** 2 + 0.75 * q ** 3)
    if q < 2.0:
        return k * 0.25 * (2 - q) ** 3
    return 0.0


def test_legacy_kernel_values():
    h = 0.26
    rs = np.linspace(0, 2.5 * h, 61)
    ours = P.cubic_kernel_2d(torch.from_numpy(rs.astype(np.float32)), h)
    ref = np.array([ref_kernel_2d(r, h) for r in rs])
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-7)


def test_legacy_kernel_normalization():
    # 2D: integral of W over the 2h-support disk == 1
    h = 0.26
    n = 400
    xs = np.linspace(-2 * h, 2 * h, n)
    dx = xs[1] - xs[0]
    gx, gy = np.meshgrid(xs, xs)
    rn = np.hypot(gx, gy)
    w = P.cubic_kernel_2d(torch.from_numpy(rn.astype(np.float32)), h)
    assert abs(w.numpy().sum() * dx * dx - 1.0) < 5e-3


def test_kernels_match_jax():
    """The kernel and its derivative as the JAX step evaluates them (under
    jit, where r / h is r * (1/h)): XLA fuses multiply-adds, so to 1e-6 of
    the largest value (~8 f32 ulps of it)."""
    h = 0.13
    r = np.random.default_rng(0).uniform(0, 2.2 * h, 4096).astype(np.float32)
    for jf, pf in ((J.cubic_kernel_2d, P.cubic_kernel_2d),
                   (J.cubic_kernel_derivative_2d,
                    P.cubic_kernel_derivative_2d)):
        ref = np.asarray(jax.jit(lambda a: jf(a, h))(r))
        got = pf(torch.from_numpy(r), h).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("name", list(P.METHODS))
def test_2d_methods_run_stable(name):
    sph = P.SPHSolver2D((200, 200), 20, [10.0, 0.0, 0.0, 10.0], dx=0.2,
                        method=P.METHODS[name], adaptive_time_step=True,
                        max_num_particles=1024, device=CPU)
    sph.add_cube([1.0, 1.0], [2.0, 3.0], P.MATERIAL_FLUID, density=[1000],
                 velocity=[0.0, -2.0])
    for f in range(12):
        dt = sph.step()
        assert dt > 0
        if f == 4:
            sph.add_cube([5.0, 6.0], [1.0, 1.0], P.MATERIAL_FLUID,
                         density=[1000], velocity=[0.0, -5.0])
    info = sph.particle_info()
    x = info["position"]
    assert len(x) == 150 + 25   # emission landed
    assert np.isfinite(x).all()
    # fluid stays inside the padded bounds (enforce_boundary semantics)
    assert (x[:, 0] >= sph.left_bound).all()
    assert (x[:, 0] <= sph.right_bound).all()
    assert (x[:, 1] >= sph.bottom_bound).all()


def test_adaptive_dt_responds_to_velocity():
    def first_dt(speed):
        sph = P.SPHSolver2D((200, 200), 20, [10.0, 0.0, 0.0, 10.0], dx=0.2,
                            method=P.METHODS["PCISPH"],
                            adaptive_time_step=True, max_num_particles=512,
                            device=CPU)
        sph.add_cube([1.0, 5.0], [1.0, 1.0], P.MATERIAL_FLUID,
                     density=[1000], velocity=[0.0, -speed])
        return sph.step()
    assert first_dt(20.0) < first_dt(0.1)  # CFL: faster fluid -> smaller dt


def test_pci_scaling_base_matches_jax():
    for dx in (0.1, 0.2):
        args = ((400, 400), 35, [11.4, 0.0, 0.0, 11.4])
        jbase = J.SPHSolver2D(*args, dx=dx, max_num_particles=8).s_f_base
        pbase = P.SPHSolver2D(*args, dx=dx, max_num_particles=8,
                              device=CPU).s_f_base
        assert pbase == jbase


# ---------------------------------------------------------------------------
# the shared scene: one JAX run per method, module-scoped
# ---------------------------------------------------------------------------

def scene_solver(mod, name, **kw):
    sph = mod.SPHSolver2D((200, 200), 20, [10.0, 0.0, 0.0, 10.0], dx=0.2,
                          method=mod.METHODS[name], adaptive_time_step=True,
                          max_num_particles=256, **kw)
    sph.add_cube([0.3, 0.45], [2.0, 2.0], mod.MATERIAL_FLUID,
                 density=[1000], velocity=[0.0, -2.0])
    return sph


def emit(sph, mod):
    sph.add_cube([1.0, 3.0], [1.0, 1.0], mod.MATERIAL_FLUID, density=[1000],
                 velocity=[0.0, -5.0])


def numpy_state(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def jax_runs():
    return make_jax_runs()


def make_jax_runs():
    """{method: (start state, [state before each step], [state after each
    step], dts, iterations)} of the JAX solver on the shared scene."""
    runs = {}
    for name in P.METHODS:
        sph = scene_solver(J, name)
        n = int(sph.state.n)
        rng = np.random.default_rng(7)
        x = np.array(sph.state.x)
        v = np.array(sph.state.v)
        x[:n] += rng.uniform(-0.02, 0.02, (n, 2)).astype(np.float32)
        v[:n] += rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
        sph.state = sph.state._replace(x=jnp.asarray(x), v=jnp.asarray(v),
                                       v_new=jnp.asarray(v))
        start = numpy_state(sph.state)
        before, after, dts, its = [], [], [], []
        for f in range(STEPS):
            before.append(numpy_state(sph.state))
            dts.append(sph.step())
            its.append(sph.it)
            after.append(numpy_state(sph.state))
            if f == EMIT_AFTER:
                emit(sph, J)
        runs[name] = (start, before, after, dts, its)
    return runs


@pytest.mark.parametrize("when", ["after_3_steps", "after_emission"])
@pytest.mark.parametrize("name", list(P.METHODS))
def test_one_step_matches_jax(jax_runs, name, when):
    _, before, after, _, its = jax_runs[name]
    f = 3 if when == "after_3_steps" else EMIT_AFTER + 1
    sph = scene_solver(P, name, device=CPU)
    state, it = sph._step(state2d_from_numpy(before[f], CPU))
    assert int(it) == its[f]
    got = state2d_to_numpy(state)
    tol = state2d_step_tolerances(sph, after[f], its[f], before[f]["dt"],
                                  *JAX_STEP_TOL)
    errors = state2d_errors(got, after[f])
    bad = {k: (errors[k], tol[k]) for k in errors if not errors[k] <= tol[k]}
    assert not bad, bad
    if when == "after_emission":
        assert got["n"] == 125
    if name == "WCSPH":
        # the EOS's atol as the docstring states it
        assert 10.0 < tol["pressure"] < 15.0


@pytest.mark.parametrize("name", list(P.METHODS))
def test_run_with_emission_matches_jax(jax_runs, name):
    start, _, _, dts, its = jax_runs[name]
    sph = scene_solver(P, name, device=CPU)
    sph.state = state2d_from_numpy(start, CPU)
    got_dts, got_its = [], []
    for f in range(STEPS):
        got_dts.append(sph.step())
        got_its.append(sph.it)
        if f == EMIT_AFTER:
            emit(sph, P)
    assert got_its == its
    np.testing.assert_allclose(got_dts, dts, rtol=RUN_DT_RTOL, atol=0)
    ref = jax_runs[name][2][-1]
    got = state2d_to_numpy(sph.state)
    assert got["n"] == ref["n"] == 125
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=RUN_X_ATOL)


@pytest.mark.parametrize("name", list(P.METHODS))
def test_fixed_dt_is_kept(name):
    sph = P.SPHSolver2D((200, 200), 20, [10.0, 0.0, 0.0, 10.0], dx=0.2,
                        method=P.METHODS[name], adaptive_time_step=False,
                        max_num_particles=256, device=CPU)
    sph.add_cube([1.0, 1.0], [1.0, 1.0], P.MATERIAL_FLUID, density=[1000],
                 velocity=[0.0, -20.0])
    dt0 = float(sph.state.dt)
    assert sph.step() == dt0 == sph.step()


def test_add_cube_past_capacity_raises():
    sph = P.SPHSolver2D((200, 200), 20, [10.0, 0.0, 0.0, 10.0], dx=0.2,
                        max_num_particles=30, device=CPU)
    sph.add_cube([1.0, 1.0], [1.0, 1.0], P.MATERIAL_FLUID)   # 25
    before = state2d_to_numpy(sph.state)
    with pytest.raises(ValueError, match="capacity"):
        sph.add_cube([3.0, 3.0], [1.0, 1.0], P.MATERIAL_FLUID)
    after = state2d_to_numpy(sph.state)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_solver_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.SPHSolver2D((200, 200), 20, [10.0, 0.0, 0.0, 10.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.build_solver("PCISPH", True, 10)
    sph = P.SPHSolver2D((200, 200), 20, [10.0, 0.0, 0.0, 10.0], device=CPU)
    assert sph.state.x.device.type == "cpu"


def test_driver_writes_pngs(tmp_path):
    """The driver's scene (capacity 2^14, 1,500 particles) for two frames
    on the CPU: a PNG at frame 0, the summary's counts."""
    out = R.main(["--method", "WCSPH", "--adaptive", "--save",
                  "--device", "cpu", "--max_frames", "2",
                  "--output_dir", str(tmp_path)])
    png = tmp_path / "000000.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out["frames"] == 2 and out["n_after"] == 1500
    assert out["reads"] == [1, 1] and not out["emitted"]


def test_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sph_taichi_tpu'] = None\n"
        "import sph_taichi_torch.legacy2d\n"
        "import sph_taichi_torch.run_simulation_2d\n"
        "import sph_taichi_torch.utils.profiling, sph_taichi_torch.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sph_taichi_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("name", list(P.METHODS))
def test_port_step_is_as_near_the_f64_step_as_jax(jax_runs, name):
    """The step in f64 (the reference that chip_smoke.py measures the card's
    f32 step from, beside the CPU's) takes the f32 step's iterations, and
    the port's f32 result lies about as near it as the JAX package's, from
    either side (``state2d_f64_witness``: not more than twice as far, plus
    JAX_STEP_TOL's share)."""
    _, before, after, _, its = jax_runs[name]
    f = EMIT_AFTER + 1
    sph = scene_solver(P, name, device=CPU)
    state, it = sph._step(state2d_from_numpy(before[f], CPU, torch.float64))
    assert state.x.dtype == torch.float64 and int(it) == its[f]
    got, _ = sph._step(state2d_from_numpy(before[f], CPU))
    f32 = state2d_to_numpy(got)
    f64 = state2d_to_numpy(state)
    for a, b in ((f32, after[f]), (after[f], f32)):
        far, worse = state2d_f64_witness(sph, a, b, f64, its[f],
                                         before[f]["dt"])
        assert not worse, worse
    assert far["x"][0] > 0   # the f64 step differs from the f32 ones


def share(err, ref, field):
    """``err`` over the largest live magnitude of ``ref[field]``."""
    a = np.abs(np.asarray(ref[field], np.float64))
    top = a.max() if field == "dt" else a[:int(ref["n"])].max(initial=0.0)
    return err / top if top else err


def print_agreement():
    """The agreement that the tolerances above are set from: for each
    method, over the single steps from every state of the shared run, the
    largest share of a field's largest live value between the port and
    the JAX package, the largest density gap, and each f32 result's
    largest share from the f64 step; the 12-step runs' gaps."""
    runs = make_jax_runs()
    floats = ("x", "v", "v_new", "pressure", "pressure_acc", "d_v", "alpha",
              "dt")
    for name in P.METHODS:
        start, before, after, dts, its = runs[name]
        sph = scene_solver(P, name, device=CPU)
        port_jax = port_f64 = jax_f64 = rho = 0.0
        for f in range(STEPS):
            got, it = sph._step(state2d_from_numpy(before[f], CPU))
            got = state2d_to_numpy(got)
            f64, _ = sph._step(state2d_from_numpy(before[f], CPU,
                                                  torch.float64))
            f64 = state2d_to_numpy(f64)
            e, ep, ej = (state2d_errors(got, after[f]),
                         state2d_errors(got, f64),
                         state2d_errors(after[f], f64))
            rho = max(rho, e["density"])
            for k in floats:
                port_jax = max(port_jax, share(e[k], after[f], k))
                port_f64 = max(port_f64, share(ep[k], f64, k))
                jax_f64 = max(jax_f64, share(ej[k], f64, k))
        sph.state = state2d_from_numpy(start, CPU)
        got_dts = []
        for f in range(STEPS):
            got_dts.append(sph.step())
            if f == EMIT_AFTER:
                emit(sph, P)
        dt_gap = np.max(np.abs(np.array(got_dts) - dts) / np.array(dts))
        x_gap = np.abs(state2d_to_numpy(sph.state)["x"]
                       - after[-1]["x"]).max()
        print(f"{name}: one step, port-JAX largest share {port_jax:.3g}, "
              f"density {rho:.3g} kg/m^3; from the f64 step, port "
              f"{port_f64:.3g}, JAX {jax_f64:.3g}; 12 steps: dt "
              f"{dt_gap:.3g} relative, x {x_gap:.3g} m")


if __name__ == "__main__":
    # python tests/test_torch_legacy2d.py (from the repository's root,
    # with it on PYTHONPATH): print the measured agreement
    torch.set_num_threads(1)
    print_agreement()
