"""Compare the compiled kernels of two checkouts, function by function.

Builds ``sph_taichi_torch/csrc``'s libraries in each checkout (its own
``ops/_build.py``, in a process of its own), disassembles them with
``cuobjdump -sass`` and compares each kernel's instructions (addresses and
encodings dropped, so a function that moved inside the library compares
equal).  Prints, per library, the kernels identical in both, those whose
SASS differs (with their instruction counts), and those only one checkout
has.  A kernel whose parameter list changed has a new mangled name: one
that only each checkout has under the same demangled name and template
arguments (``cu++filt`` or ``c++filt``) is compared as the same kernel and
listed with its parameter lists.  Of the kernels left that only one
checkout has, those with the same instructions are listed in pairs (a
kernel renamed, or one that became a template instantiation, where no
demangler is on the path).

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


def demangled(names):
    """{mangled name: demangled name} of ``names`` (empty without a
    demangler)."""
    tool = (shutil.which("cu++filt") or shutil.which("c++filt")
            or "/usr/local/cuda/bin/cu++filt")
    if not names or not os.path.exists(tool):
        return {}
    out = subprocess.run([tool], input="\n".join(names), check=True,
                         capture_output=True, text=True).stdout
    return dict(zip(names, out.splitlines()))


def split_params(name):
    """(the demangled name with its template arguments, its parameter
    list): split at the first '(' outside the template brackets."""
    depth = 0
    for k, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return name[:k], name[k:]
    return name, ""


def renamed(a, b):
    """[(key, name in a, name in b)] of the kernels only ``a`` and only
    ``b`` has whose demangled names differ only in the parameter list."""
    only_a, only_b = sorted(a.keys() - b.keys()), sorted(b.keys() - a.keys())
    names = demangled(only_a + only_b)
    keys_a = {split_params(names[k])[0]: k for k in only_a if k in names}
    pairs = []
    for k in only_b:
        key = split_params(names.get(k, k))[0]
        if k in names and key in keys_a:
            pairs.append((key, keys_a[key], k, names))
    return pairs


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
        moved = renamed(a, b)
        only_a = sorted(a.keys() - b.keys() - {m[1] for m in moved})
        only_b = sorted(b.keys() - a.keys() - {m[2] for m in moved})
        n_same = sum(a[ka] == b[kb] for _, ka, kb, _ in moved)
        print(f"{lib}: {len(same) + n_same} kernels identical ({n_same} of "
              f"them with a new parameter list), "
              f"{len(diff) + len(moved) - n_same} differ, {len(only_a)} "
              f"only in {args.other}, {len(only_b)} only in {args.root}")
        for k in diff:
            print(f"  differs: {k} ({len(a[k])} -> {len(b[k])} "
                  f"instructions)")
        for key, ka, kb, names in moved:
            print(f"  {'identical' if a[ka] == b[kb] else 'differs'}, "
                  f"parameters {split_params(names[ka])[1]} -> "
                  f"{split_params(names[kb])[1]}: {key} ({len(a[ka])} -> "
                  f"{len(b[kb])} instructions)")
        for ka, kb in ((ka, kb) for ka in only_a for kb in only_b
                       if a[ka] == b[kb]):
            print(f"  identical instructions: {ka} in {args.other}, {kb} "
                  f"in {args.root}")
        for k in only_a:
            print(f"  only in {args.other}: {k} ({len(a[k])} instructions)")
        for k in only_b:
            print(f"  only in {args.root}: {k} ({len(b[k])} instructions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
