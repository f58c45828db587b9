#!/usr/bin/env python3
"""Time K5, the banded wavefront kernel, of one tree of the port on the card.

At the engine's K5 chunk (``chip_smoke.k5_chunk``: 16,384 pairs of noisy
16.5-20 kb copies, L = 32,768), NW and HW, for each band asked for: the
kernel's ms and its bound, both as this tree's ``chip_smoke.time_k5`` and
``chip_smoke.bound_ms`` compute them.  Prints the card's name and power
limit, the register kernel's ptxas registers and spills, and one JSON line
per reading.  The result is not checked here: ``chip_smoke.py`` holds it to
the plain version at the same shape.

``--root DIR`` runs the kernel of the tree unpacked in DIR (its
``isocon_tpu_torch``) under this tree's timing and bound, so that two trees
are compared on one card in one call, in turns, one process each:

    python tools/k5_time.py --root OLD; python tools/k5_time.py
    python tools/k5_time.py; python tools/k5_time.py --root OLD
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--wp", type=int, nargs="+", default=[128, 256])
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs     # this tree's timing and bound
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)    # the kernel under test
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k5_time: no CUDA device")
    from isocon_tpu_torch.ops import _build, wavefront

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi("name,power.limit")
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm").split()[0])
    print(smi)
    _build.build_all()
    for kernel, regs, spill in cs.register_kernel_report(_build.BUILD_LOG):
        print("K5 register kernel %s: %d registers, %s" % (kernel, regs, spill))
    chunk = cs.k5_chunk(torch, np, dev)
    for Wp in args.wp:
        for hw_mode in (False, True):
            ms, _got, nbytes, ops, shape = cs.time_k5(torch, wavefront, chunk,
                                                      Wp, hw_mode)
            bound, by = cs.bound_ms(nbytes, ops, clock_mhz)
            print(json.dumps({
                "tree": os.path.relpath(root, HERE), "mode": "HW" if hw_mode
                else "NW", "shape": shape, "ms": ms, "bound_ms": bound,
                "bound_by": by, "ratio": ms / bound, "card": smi}),
                flush=True)


if __name__ == "__main__":
    main()
