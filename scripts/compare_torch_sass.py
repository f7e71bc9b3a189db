#!/usr/bin/env python
"""Compare the SASS of the kernels two builds of the port's library share.

    python3 scripts/compare_torch_sass.py OLD.so NEW.so [NAME ...]

Disassembles both libraries with ``cuobjdump -sass`` (CUDA toolkit), splits
them into kernels on "Function : " and strips addresses and encodings.
For each NAME, the kernels whose mangled names hold it are paired in
order between the builds (a kernel's mangled name changes with the
namespace of its parameter types); without NAMEs, every kernel of the
same mangled name in both.  Prints for each pair whether its instructions
are identical, with the instruction counts and the number of differing
lines.  Exits 1 if a NAME matches a different number of kernels in the
two builds or a pair differs.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("compare_torch_sass: cuobjdump not found")


def kernels(lib: str) -> dict:
    """{mangled name: [instruction, ...]} of ``lib``."""
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        out[name] = [line.split("*/", 1)[1].split("/*")[0].strip()
                     for line in section.splitlines()[1:]
                     if line.strip().startswith("/*")
                     and not line.strip().startswith("/* 0x")
                     and "*/" in line]
    return out


def main() -> None:
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    old, new = kernels(sys.argv[1]), kernels(sys.argv[2])
    keys = sys.argv[3:]
    if keys:
        pairs = []
        for k in keys:
            a = sorted(n for n in old if k in n)
            b = sorted(n for n in new if k in n)
            if len(a) != len(b) or not a:
                print(f"{k}: {len(a)} kernels in the old build, {len(b)} in "
                      f"the new")
                sys.exit(1)
            pairs += list(zip(a, b))
    else:
        pairs = [(n, n) for n in sorted(set(old) & set(new))]
    bad = 0
    for na, nb in pairs:
        a, b = old[na], new[nb]
        diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(f"{nb}: {len(a)} / {len(b)} instructions, "
              f"{'identical' if diff == 0 else f'{diff} lines differ'}")
        bad += diff != 0
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
