"""Compare the compiled kernels of two checkouts, function by function.

Builds ``sph_taichi_torch/csrc``'s libraries in each checkout (its own
``ops/_build.py``, in a process of its own), disassembles them with
``cuobjdump -sass`` and compares each kernel's instructions (addresses and
encodings dropped, so a function that moved inside the library compares
equal).  Prints, per library, the kernels identical in both, those whose
SASS differs (with their instruction counts), and those only one checkout
has.

    python3 tools/sass_diff.py OTHER_ROOT [--root ROOT] [--libs pairs dfsph]

Needs the CUDA toolkit (nvcc, cuobjdump); no card.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("pairs", "dfsph", "iisph", "pcisph")


def build(root, libs):
    """{lib: .so path} of ``root``'s build of ``libs``."""
    code = ("import json, sys; sys.path.insert(0, '.'); "
            "from sph_taichi_torch.ops import _build; "
            f"print(json.dumps({{k: str(v) for k, v in "
            f"_build.build({list(libs)!r}).items()}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout
    import json
    return json.loads(out.strip().splitlines()[-1])


def functions(lib):
    """{kernel's mangled name: its instructions} of a library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the checkout to compare with")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--libs", nargs="+", default=list(LIBS))
    args = ap.parse_args()
    mine = build(args.root, args.libs)
    theirs = build(os.path.abspath(args.other), args.libs)
    for lib in args.libs:
        a, b = functions(theirs[lib]), functions(mine[lib])
        same = sorted(k for k in a.keys() & b.keys() if a[k] == b[k])
        diff = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
        print(f"{lib}: {len(same)} kernels identical, {len(diff)} differ, "
              f"{len(a.keys() - b.keys())} only in {args.other}, "
              f"{len(b.keys() - a.keys())} only in {args.root}")
        for k in diff:
            print(f"  differs: {k} ({len(a[k])} -> {len(b[k])} "
                  f"instructions)")
        for k in sorted(a.keys() - b.keys()):
            print(f"  only in {args.other}: {k} ({len(a[k])} instructions)")
        for k in sorted(b.keys() - a.keys()):
            print(f"  only in {args.root}: {k} ({len(b[k])} instructions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
