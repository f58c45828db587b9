#!/usr/bin/env python3
"""The loops of a kernel's SASS, counted by opcode.

Builds the port's kernels of one tree (``--root``, default this one) as
``chip_smoke.py`` does, disassembles the library of ``--source`` with
``cuobjdump -sass`` and, for every function whose mangled name contains
``--kernel``, prints its instruction count and each loop: a backward
branch and the instructions from its target to it, with the count of each
opcode (the part before the first dot: ``LOP3.LUT`` counts as ``LOP3``)
and how many other loops it holds, after ptxas' register and spill report
of the source if it was built.  ``--dump FILE`` writes the whole
disassembly too.  Needs nvcc and cuobjdump (``/usr/local/cuda`` or
``CUDA_HOME``); there is no card needed once they build.

    python tools/sass_loops.py --source myers_ed \\
        --kernel myers_band_kernelILi7ELi128ELb0E [--root OLD] [--dump F]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def parse(sass: str):
    """{function: [(address, opcode, text)]} and {function: {label:
    address}} of ``cuobjdump -sass`` output."""
    funcs, labels = {}, {}
    cur, pending = None, []
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur], pending = [], {}, []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.match(line)
        if m:
            addr = int(m.group(1), 16)
            text = m.group(2).strip()
            body = re.sub(r"^@!?U?P\w+\s+", "", text)
            op = body.split()[0].split(".")[0] if body else "?"
            funcs[cur].append((addr, op, text))
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
    return funcs, labels


def loops(insns, labels):
    """(start, end) address of each backward branch's span."""
    out = []
    for addr, op, text in insns:
        if op not in ("BRA", "JMP"):
            continue
        m = re.search(r"`?\(?(\.L_x_\d+)\)?`?", text)
        if m and m.group(1) in labels:
            target = labels[m.group(1)]
        else:
            m = re.search(r"0x([0-9a-f]+)", text)
            if not m:
                continue
            target = int(m.group(1), 16)
        if target <= addr:
            out.append((target, addr))
    return sorted(set(out))


def report(insns, labels):
    spans = loops(insns, labels)
    rows = []
    for lo, hi in spans:
        ops = collections.Counter(op for a, op, _t in insns if lo <= a <= hi)
        inner = sum(1 for s in spans if s != (lo, hi) and lo <= s[0]
                    and s[1] <= hi)
        rows.append({"start": "%04x" % lo, "end": "%04x" % hi,
                     "instructions": sum(ops.values()), "inner_loops": inner,
                     "opcodes": dict(ops.most_common())})
    return {"instructions": len(insns), "loops": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--source", required=True,
                    help="csrc file name without .cu, e.g. myers_ed")
    ap.add_argument("--kernel", required=True,
                    help="a part of the mangled function name")
    ap.add_argument("--dump", help="write the whole disassembly here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from isocon_tpu_torch.ops import _build

    secs = _build.build_all()
    print("built in %.1f s" % secs)
    for entry in _build.BUILD_LOG:      # ptxas' report of this source
        if entry.startswith("== %s ==" % args.source):
            for line in entry.splitlines():
                if "Compiling entry" in line or "Used" in line or \
                        "spill" in line:
                    print("  " + line.strip())
    lib = _build._lib_path(args.source)
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                           "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        with open(args.dump, "w") as fh:
            fh.write(sass)
    funcs, labels = parse(sass)
    hits = [f for f in funcs if args.kernel in f]
    if not hits:
        sys.exit("sass_loops: no function matches %r" % args.kernel)
    for f in hits:
        print(json.dumps({"tree": os.path.relpath(root, HERE),
                          "function": f, **report(funcs[f], labels[f])}),
              flush=True)


if __name__ == "__main__":
    main()
