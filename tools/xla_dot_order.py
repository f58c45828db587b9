"""Which row counts XLA:CPU sums the JAX sketch score in sequential-FMA order.

``isocon_tpu.graph.sketch._topn_scores`` computes its score with
``jnp.dot``, whose float32 summation order XLA leaves to its backend.  For
each N given, this script makes N seeded profiles (Poisson(3) k-mer counts,
D = 512, lengths 300-319), runs the JAX function (top min(20, N - 1)) on
the CPU and the port's plain version (``sketch_scores_plain``: one in-order
chain of exact float32 fmas per entry), and prints one JSON line per N with
the share of the first rows' top-n values that are equal bit for bit, and
whether their index lists are equal.  A share of 1.0 means XLA:CPU took the
sequential order at that shape.

Usage: JAX_PLATFORMS=cpu python tools/xla_dot_order.py [N ...]
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_N = (2, 3, 4, 16, 17, 48, 49, 64, 65, 96, 128, 200, 256, 300, 512,
             1000, 1024, 2000, 2048, 3000)
ROWS = 32


def main() -> None:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from isocon_tpu.graph.sketch import _topn_scores
    from isocon_tpu_torch.ops.sketch import sketch_scores_plain, topn

    for n in [int(a) for a in sys.argv[1:]] or DEFAULT_N:
        rs = np.random.default_rng(n)
        prof = rs.poisson(3, size=(n, 512)).astype(np.float32)
        lens = rs.integers(300, 320, n).astype(np.int32)
        k = min(20, n - 1)
        vals, idx = _topn_scores(jnp.asarray(prof), jnp.asarray(lens), k)
        rows = min(n, ROWS)
        scores = sketch_scores_plain(torch.sqrt(torch.from_numpy(prof)),
                                     torch.from_numpy(lens), 0, rows)
        pv, pi = topn(scores, k)
        print(json.dumps({
            "n": n, "rows_compared": rows,
            "values_equal_share": float(
                (pv.numpy() == np.asarray(vals)[:rows]).mean()),
            "lists_equal": bool(np.array_equal(pi.numpy(),
                                               np.asarray(idx)[:rows]))}),
              flush=True)


if __name__ == "__main__":
    main()
