#!/usr/bin/env python
"""Compare the SASS of the kernels two builds of the port's library share.

    python3 scripts/compare_torch_sass.py OLD.so NEW.so [NAME ...]

Disassembles both libraries with ``cuobjdump -sass`` (CUDA toolkit), splits
them into kernels on "Function : " and strips addresses and encodings.
For each NAME, the kernels whose mangled names hold it are paired in
order between the builds (a kernel's mangled name changes with the
namespace of its parameter types); without NAMEs, every kernel by its
mangled name, less the hash nvcc puts in the name of a source's anonymous
namespace (``_GLOBAL__N__<hash>_``: two builds of one unchanged source
can differ there).  Prints for each pair whether its instructions are
identical, with the instruction counts and the number of differing lines.
Exits 1 if a NAME matches a different number of kernels in the two
builds, if without NAMEs a kernel is in one build only, or if a pair
differs.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("compare_torch_sass: cuobjdump not found")


ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


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
        by_old = {ANON.sub("_GLOBAL__N__", n): n for n in old}
        by_new = {ANON.sub("_GLOBAL__N__", n): n for n in new}
        if by_old.keys() != by_new.keys():
            print(f"in one build only: old "
                  f"{sorted(by_old.keys() - by_new.keys())}, new "
                  f"{sorted(by_new.keys() - by_old.keys())}")
            sys.exit(1)
        pairs = [(by_old[k], by_new[k]) for k in sorted(by_old)]
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
