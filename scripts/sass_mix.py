#!/usr/bin/env python3
"""Instruction mix of a built kernel library, from its SASS.

  python3 scripts/sass_mix.py [name] [function-substring ...]

Builds ``t1k_tpu_torch/csrc/<name>.cu`` (default align_full) if needed,
runs ``cuobjdump -sass`` on the library and prints, for each kernel
whose name holds one of the substrings (all kernels without any), its
instruction count and the opcodes by count, then each loop (a branch
back to a lower address): its instructions and the opcodes by count.  A
static count: each unrolled loop body counts once, whatever the loop's
trip count.  Needs the CUDA toolkit; no card.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# "        /*0a40*/                   VIADDMNMX R5, R4, -0x5, R7, !PT ;"
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_]*)([^;]*)")
_TARGET = re.compile(r"\b(0x[0-9a-f]+)\s*$")


def listing(sass: str):
    """{function: [(address, opcode, operands)]} of cuobjdump -sass
    output."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSN.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2).split(".")[0],
                            m.group(3)))
    return funcs


def mix(insns) -> collections.Counter:
    return collections.Counter(op for _, op, _ in insns)


def loops(insns):
    """(first address, last address, instructions) of each branch back to
    a lower address."""
    out = []
    for addr, op, args in insns:
        m = _TARGET.search(args.strip()) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            out.append((lo, addr, [x for x in insns if lo <= x[0] <= addr]))
    return out


def _top(ops: collections.Counter) -> str:
    return " ".join(f"{op}={k}" for op, k in ops.most_common())


def main(argv) -> int:
    from t1k_tpu_torch.ops import _build

    name = argv[0] if argv else "align_full"
    lib = _build.build(name)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    for func, insns in sorted(listing(sass).items()):
        if argv[1:] and not any(s in func for s in argv[1:]):
            continue
        print(f"{func}: {len(insns)} instructions: {_top(mix(insns))}")
        for lo, hi, body in loops(insns):
            print(f"  loop {lo:#x}-{hi:#x}: {len(body)} instructions: "
                  f"{_top(mix(body))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
