"""The port's public surface against the JAX package's, on the CPU.

- The sharded dry run (``entry.dryrun_multichip``), its command line
  (``entry.main``) and the rank launcher (``parallel.comm.launch``) run on
  the card unless the caller names the CPU: with no card (faked here by
  patching ``torch.cuda.is_available`` and ``device_count``, so the cases
  hold on a machine with one too) they raise before any rank starts.
- ``ops.kernels.cubic_kernel_derivative`` (the vector gradient) against the
  JAX function on numpy-seeded vectors in 2D and 3D: near and far
  branches, q = 0.5, q = 1, |r| <= 1e-5 and q > 1, at rtol 1e-6 and atol
  1e-6 x max |grad W| (the two packages may round q an ulp apart: XLA may
  multiply by 1/h where the port divides; both branches meet at q = 0.5
  and vanish at q = 1, so a flipped branch stays inside that).
- ``ops.neighbors.gather_neighbors`` against the JAX function, bitwise.
- Every name that ``sph_taichi_tpu.ops``, ``.models`` and ``.parallel``
  export is importable from the port's package of the same name, as the
  port's own object, and importing them builds no CUDA library and
  imports no ``triton``.

One torch thread for the module (its cases take a few seconds alone).
"""

import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sph_taichi_tpu as J
import sph_taichi_tpu.models
import sph_taichi_tpu.ops
import sph_taichi_tpu.parallel
from sph_taichi_tpu.ops import grid as jgrid
from sph_taichi_tpu.ops import kernels as jkernels
from sph_taichi_tpu.ops import neighbors as jneighbors

import sph_taichi_torch as T
from sph_taichi_torch import convert, entry
from sph_taichi_torch.ops import grid as tgrid
from sph_taichi_torch.ops import kernels as tkernels
from sph_taichi_torch.ops import neighbors as tneighbors
from sph_taichi_torch.parallel import comm as pcomm

from conftest import _clumped_positions, small_scene_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def _never(*args, **kwargs):
    raise AssertionError("a rank was launched")


# ---------------------------------------------------------------------------
# the sharded dry run runs on the card unless the CPU is named
# ---------------------------------------------------------------------------

CALLS = {
    "dryrun_multichip": lambda: entry.dryrun_multichip(2),
    "entry.main": lambda: entry.main(["--ranks", "2"]),
    "comm.launch": lambda: pcomm.launch(entry.run_scenarios, 2,
                                        args=([],)),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_without_a_card_the_default_raises(no_card, monkeypatch, call):
    # nothing may be spawned or stepped before the refusal
    monkeypatch.setattr(pcomm.tempfile, "mkdtemp", _never)
    monkeypatch.setattr(entry, "entry", _never)
    with pytest.raises(RuntimeError, match="cpu"):
        CALLS[call]()


def test_main_hands_the_dry_run_cpu_devices(no_card, monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(entry, "dryrun_multichip",
                        lambda n, devices=None: seen.append((n, devices)))
    assert entry.main(["--device", "cpu", "--ranks", "2"]) == 0
    assert seen == [(2, ["cpu", "cpu"])]
    assert "on cpu" in capsys.readouterr().out


def test_main_leaves_the_dry_run_on_the_cards(monkeypatch):
    """With a card ``main`` leaves ``devices`` unset, and the dry run and
    the launcher give each rank a card, round-robin."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    seen = []
    monkeypatch.setattr(entry, "entry", lambda device: (
        lambda s: s, (seen.append(device) or _tiny_state(),)))
    monkeypatch.setattr(entry, "dryrun_multichip",
                        lambda n, devices=None: seen.append((n, devices)))
    assert entry.main(["--ranks", "3"]) == 0
    assert seen == [torch.device("cuda"), (3, None)]
    assert pcomm.cuda_devices(3) == ["cuda:0", "cuda:1", "cuda:0"]


def _tiny_state():
    params, part, _ = T.build_scene(
        T.SimConfig(config_dict=small_scene_dict()), device="cpu")
    return T.build_solver(params, device="cpu").initialize(part)


# ---------------------------------------------------------------------------
# cubic_kernel_derivative and gather_neighbors against the JAX functions
# ---------------------------------------------------------------------------

def _gradient_inputs(rng, h, dim):
    """Vectors of length q h in random directions: q over the near and
    far branches and past 1, q = 0.5 and q = 1 along each axis, and
    lengths at and under the 1e-5 cutoff."""
    q = np.concatenate([rng.uniform(0.0, 0.5, 512),
                        rng.uniform(0.5, 1.0, 512),
                        rng.uniform(1.0, 1.5, 256)])
    u = rng.normal(size=(q.size, dim))
    r = u / np.linalg.norm(u, axis=1, keepdims=True) * (q * h)[:, None]
    axes = np.eye(dim)
    special = [axes * (0.5 * h), axes * h, -axes * (0.5 * h), -axes * h,
               axes * 1e-5, axes * 0.5e-5, np.zeros((1, dim)),
               u[:4] / np.linalg.norm(u[:4], axis=1, keepdims=True) * 1e-5]
    return np.concatenate([r] + special).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("h", [0.04, 0.1])
def test_cubic_kernel_derivative_matches_jax(dim, h):
    r = _gradient_inputs(np.random.default_rng(dim), h, dim)
    got = tkernels.cubic_kernel_derivative(torch.from_numpy(r), h,
                                           dim).numpy()
    ref = np.asarray(jkernels.cubic_kernel_derivative(jnp.asarray(r), h,
                                                      dim))
    assert got.dtype == np.float32 and got.shape == r.shape
    scale = float(np.abs(ref).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * scale)
    # the cutoffs: zero at |r| <= 1e-5 and past q = 1, in both
    norm = np.sqrt((r.astype(np.float64) ** 2).sum(1))
    off = (norm <= 0.9e-5) | (norm >= 1.01 * h)
    assert off.sum() > 200
    assert not got[off].any() and not ref[off].any()
    on = (norm > 2e-5) & (norm < 0.99 * h)
    assert np.linalg.norm(got[on], axis=1).min() > 0.0


def test_gather_neighbors_matches_jax():
    rng = np.random.default_rng(5)
    jp, jpart, _ = J.build_scene(J.SimConfig(config_dict=small_scene_dict()))
    jpart = jpart._replace(x=jnp.asarray(_clumped_positions(rng, jp, jpart)))
    tpart = convert.particles_from_numpy(
        {k: np.asarray(v) for k, v in jpart._asdict().items()
         if v is not None}, "cpu")
    jids = jgrid.compute_cell_ids(jpart.x, jpart.material, jp.grid_size,
                                  jp.grid_num)
    js, jsids = jgrid.sort_by_cell(jpart, jids)
    jnl = jneighbors.build_neighbor_list(
        js.x, jgrid.cell_offsets(jsids, jp.num_cells), jp.grid_num,
        jp.grid_size, jp.support_radius, jp.neighbor_cap, jp.cell_cap)
    tids = tgrid.compute_cell_ids(tpart.x, tpart.material, jp.grid_size,
                                  jp.grid_num)
    ts, tsids = tgrid.sort_by_cell(tpart, tids)
    tnl = tneighbors.build_neighbor_list(
        ts.x, tgrid.cell_offsets(tsids, jp.num_cells), jp.grid_num,
        jp.grid_size, jp.support_radius, jp.neighbor_cap, jp.cell_cap)
    assert int(tnl.max_cnt) > 20
    fields = {"vectors": rng.uniform(-1, 1, (tpart.n, 3)),
              "scalars": rng.uniform(-1, 1, tpart.n)}
    for name, a in fields.items():
        a = a.astype(np.float32)
        got = tneighbors.gather_neighbors(torch.from_numpy(a), tnl).numpy()
        ref = np.asarray(jneighbors.gather_neighbors(jnp.asarray(a), jnl))
        assert got.shape == ref.shape == (tpart.n, jp.neighbor_cap,
                                          *a.shape[1:])
        np.testing.assert_array_equal(got, ref, err_msg=name)


# ---------------------------------------------------------------------------
# the exported names
# ---------------------------------------------------------------------------

def _exports(module):
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


@pytest.mark.parametrize("package", ["ops", "models", "parallel"])
def test_port_exports_the_jax_names(package):
    jmod = getattr(sph_taichi_tpu, package)
    names = _exports(jmod)
    assert names, package
    tmod = __import__(f"sph_taichi_torch.{package}", fromlist=["_"])
    for name in names:
        obj = getattr(tmod, name)
        assert obj.__module__.startswith("sph_taichi_torch."), name
        assert obj.__name__ == name
    assert _exports(tmod) == names


def test_importing_the_exports_builds_nothing():
    code = (
        "import sys\n"
        "from sph_taichi_torch.ops import _build\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a CUDA library was built at import')\n"
        "_build.build = _build._nvcc = refuse\n"
        "from sph_taichi_torch.ops import *\n"
        "from sph_taichi_torch.models import *\n"
        "from sph_taichi_torch.parallel import *\n"
        "from sph_taichi_torch import ops, models, parallel\n"
        "from sph_taichi_torch.ops import (cuda_dfsph, cuda_iisph,"
        " cuda_pairs, cuda_pcisph)\n"
        "assert not _build._loaded, _build._loaded\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('triton', 'jax', 'jaxlib', 'sph_taichi_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
