"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>/lib<name>.so``
at the repository root, where the hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  The
sources have a plain C interface and include no PyTorch header, so a build
takes seconds.  Nothing here runs at import time; a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded = {}

# every source a step may load
SOURCES = ("pairs", "dfsph", "iisph", "pcisph")


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return nvcc


def _target(name):
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / f"{name}-{key.hexdigest()[:16]}"
    return src, out_dir, out_dir / f"lib{name}.so"


def build(names):
    """Build every named source that has no up-to-date library, one nvcc
    process per source, all started together.  Returns {name: .so path}."""
    procs, libs = {}, {}
    for name in names:
        src, out_dir, lib = _target(name)
        libs[name] = lib
        if lib.exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        log = open(out_dir / "build.log", "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + Path(log.name).read_text())
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def build_log(name):
    """The compiler's output (ptxas register and spill counts) of the
    current build of ``name``."""
    log = _target(name)[1] / "build.log"
    return log.read_text() if log.exists() else ""


def load(name):
    """ctypes handle of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
