"""Opcode counts of a kernel in a built library, from its SASS.

    python tests/torch_sass_counts.py LIBRARY_GLOB NEEDLE

LIBRARY_GLOB names a library that ``ops/_build.py`` built (for example
``"build/kernels/*/libnlm.so"``), NEEDLE a part of the kernel's mangled
name (``nlm_reg_kernelILi3ELi1E``: the register route at C 3, p 1).  For
each kernel whose name holds it, prints the instruction count and the
most frequent opcodes, and the same for its largest loop (the longest
span closed by a backward branch), which is the per-offset body of
kernel 16's register route: its length over 8 output rows is the
instructions a pixel-offset.  Needs ``cuobjdump`` (the CUDA toolkit, on
the machine with the card).
"""

import collections
import glob
import re
import subprocess
import sys

_LINE = re.compile(
    r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _opcodes(lines):
    counts = collections.Counter()
    for ln in lines:
        m = _LINE.match(ln)
        if m:
            counts[m.group(3).split(".")[0]] += 1
    return counts


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    paths = glob.glob(argv[0])
    if not paths:
        print(f"no library matches {argv[0]}", file=sys.stderr)
        return 1
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", paths[0]],
                          capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass):
        name = func.split("\n", 1)[0]
        if argv[1] not in name:
            continue
        lines = [ln for ln in func.splitlines() if _LINE.match(ln)]
        addr = [int(_LINE.match(ln).group(1), 16) for ln in lines]
        counts = _opcodes(lines)
        print(name[:100], "instructions", sum(counts.values()))
        print(" ", dict(counts.most_common(30)))
        best = []
        for i, ln in enumerate(lines):
            if "BRA" not in ln:
                continue
            target = re.search(r"0x([0-9a-f]+)", ln.split("BRA", 1)[1])
            if target and int(target.group(1), 16) < addr[i]:
                lo = int(target.group(1), 16)
                span = [x for x, a in zip(lines, addr) if lo <= a <= addr[i]]
                if len(span) > len(best):
                    best = span
        if best:
            loop = _opcodes(best)
            print("  largest loop:", sum(loop.values()),
                  dict(loop.most_common(30)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
