"""The port's ``parallel/`` mesh and ``Sharder`` against the port's
unsharded wrappers and the JAX package's ``Sharder`` (on the 8 virtual CPU
devices of conftest.py).

On the CPU a mesh is n logical shards of ``cpu``; each block runs the
kernels' plain versions.  The four pooled kernel wrappers (K1 at windows
7 and 33, K2, K5 at bands 128 and 256 in both modes, K3 + K4) run through
``Sharder.launch`` and ``Sharder.collect``, the engine's route, on ragged
batches (B not a multiple of n, and B < n) for n = 2, 3 and 8.  The
sharded engine, the pipeline, the seam and the CLI are in
test_torch_parallel_engine.py (two files, so that each stays near two
minutes under ``--dist loadfile``).  Tolerance: exact.
"""
import ast
import gc
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from isocon_tpu.ops.affine import ops_to_alignment_counts as jax_counts
from isocon_tpu.ops.affine_pallas_c import unpack_ops
from isocon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from isocon_tpu.parallel.sharding import Sharder as JaxSharder
from isocon_tpu_torch.ops import affine_cuda as tac
from isocon_tpu_torch.ops import myers as tm
from isocon_tpu_torch.ops import wavefront as tw
from isocon_tpu_torch.ops.engine import pool_from_numpy
from isocon_tpu_torch import parallel
from isocon_tpu_torch.parallel import Sharder, distributed, make_mesh
from test_torch_affine import _inputs as affine_inputs
from test_torch_myers import make_pairs as myers_code_pairs
from test_torch_wavefront import _pairs as wavefront_code_pairs

P = 48          # pairs in each route's pool
NS = (2, 3, 8)  # logical shards


def _cpu_mesh(n):
    return make_mesh(n, "cpu")


def _sizes(n):
    """Batch sizes: not a multiple of n, and below n."""
    return (5 * n + 1, n - 1)


def _pick(B, seed=0):
    ia = np.random.default_rng(seed).permutation(P)[:B].astype(np.int32)
    return ia, ia + P


def _jax_pad(x, grain):
    """The JAX Sharder's batch: padded with the last pair to ``grain``."""
    return np.concatenate([x, np.repeat(x[-1:], grain - len(x))])


def _sharded(sh, fn, tensors, vectors, **kw):
    """``fn`` over ``sh``'s mesh as the engine runs a batch: launched on
    every block, then collected to host arrays."""
    return sh.collect(sh.launch(fn, tensors, vectors, **kw))


def _pool(q, t, ql, tl, L):
    pool_np = np.concatenate([q, t])
    plen_np = np.concatenate([ql, tl]).astype(np.int32)
    pool, plen = pool_from_numpy(pool_np.reshape(-1), plen_np, L, "cpu")
    return pool_np.reshape(-1), plen_np, pool, plen


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------
def test_make_mesh_cpu_gives_logical_shards():
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert make_mesh(-1, "cpu") == [torch.device("cpu")]
    assert make_mesh(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    sh = Sharder(make_mesh(3, "cpu"))
    assert (sh.n, sh.local, sh.multiprocess) == (3, [0, 1, 2], False)


def test_make_mesh_cuda_never_becomes_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; test_torch_cuda.py covers it")
    with pytest.raises(RuntimeError):
        make_mesh(2, "cuda")


def test_global_mesh_of_one_process():
    mesh = distributed.make_global_mesh(make_mesh(2, "cpu"))
    assert list(mesh) == [torch.device("cpu")] * 2 and mesh.ranks == [0, 0]
    assert distributed.process_count() == 1
    assert not distributed.initialize_from_env()


def test_replicas_follow_the_pool():
    """One copy a device other than the pool's, kept for the pool's life:
    rows the pool appends are copied into it, and it is made again when
    the pool moves into larger storage; the pool's own device uses the
    pool, and the Sharder holds the source only weakly.  ``cpu:0`` is
    not the pools' ``cpu``, so it takes the copy path on the CPU."""
    sh = Sharder(make_mesh(1, "cpu"))
    other_dev = torch.device("cpu", 0)
    mat = torch.arange(8 * 16, dtype=torch.int32).reshape(8, 16).to(
        torch.uint8)
    lens = torch.arange(8, dtype=torch.int32)
    assert sh._replica((mat[:4], lens[:4]), torch.device("cpu"))[0] \
        .data_ptr() == mat.data_ptr()
    first = sh._replica((mat[:4], lens[:4]), other_dev)
    assert first[0].data_ptr() != mat.data_ptr()
    assert torch.equal(first[0], mat[:4]) and torch.equal(first[1], lens[:4])
    # rows already copied are not copied again (written here against the
    # pool's rule only to see it), appended ones are
    mat[0] = 99
    grown = sh._replica((mat[:6], lens[:6]), other_dev)
    assert grown[0].data_ptr() == first[0].data_ptr()
    assert int(grown[0][0, 0]) == 0
    assert torch.equal(grown[0][1:], mat[1:6])
    assert torch.equal(grown[1], lens[:6])
    # the pool grows into new storage, its old one freed (the Sharder
    # held it weakly): a fresh copy of every row
    bigger = torch.zeros((16, 16), dtype=torch.uint8)
    bigger[:8] = mat
    ref = weakref.ref(mat)
    del mat
    gc.collect()
    assert ref() is None
    moved = sh._replica((bigger[:9], lens[:8].repeat(2)[:9]), other_dev)
    assert moved[0].data_ptr() != first[0].data_ptr()
    assert torch.equal(moved[0], bigger[:9])


@pytest.mark.parametrize("name", ["sharding", "mesh", "distributed"])
def test_parallel_modules_import_no_kernel_module(name):
    """The block launcher knows no kernel: these modules import nothing
    from ``isocon_tpu_torch.ops`` (the engine hands ``Sharder.launch`` the
    kernels' wrappers), so the imports run one way, ops -> parallel."""
    path = Path(parallel.__file__).with_name(name + ".py")
    here = "isocon_tpu_torch.parallel"
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = here.rsplit(".", node.level - 1)[0] if node.level else ""
            mod = ".".join(x for x in (base, node.module) if x)
            found += [mod] + [mod + "." + a.name for a in node.names]
    assert found
    assert not [m for m in found if m == "isocon_tpu_torch.ops"
                or m.startswith("isocon_tpu_torch.ops.")], found


# ---------------------------------------------------------------------------
# the pooled kernel wrappers through the Sharder's launch and collect
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def myers_data():
    """K1/K2 pairs of up to 288 codes, in pools of width 288 (window 7)
    and 1056 (window 33, the narrowest it takes)."""
    q, t, ql, tl = myers_code_pairs(7, P, 288)
    wide = lambda x: np.pad(x, ((0, 0), (0, 1056 - 288)), constant_values=6)
    return {288: (288, *_pool(q, t, ql, tl, 288)),
            1056: (1056, *_pool(wide(q), wide(t), ql, tl, 1056))}


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("win,hw", [(7, False), (33, False), (7, True)],
                         ids=["k1_win7", "k1_win33", "k2_win7"])
def test_sharded_myers_matches_local_and_jax(myers_data, n, win, hw):
    """Each pair's answer in a ragged batch launched and collected over the
    mesh equals the unsharded wrapper's and the JAX Sharder's on all the
    pool's pairs."""
    L, pool_flat, plen_np, pool, plen = myers_data[288 if win == 7
                                                   else 1056]
    peq = tm.peq_table(pool, plen)
    every = np.arange(P, dtype=np.int32)
    port_fn = tm.myers_hw_pool if hw else tm.myers_ed_pool
    local = port_fn(pool, plen, peq, torch.from_numpy(every),
                    torch.from_numpy(every + P), L=L, win=win)
    jsh = JaxSharder(jax_make_mesh(n))
    want = (jsh.myers_hw_pool if hw else jsh.myers_ed_pool)(
        pool_flat, plen_np, _jax_pad(every, 128 * n),
        _jax_pad(every + P, 128 * n), L=L, sub=1, win=win)
    if not hw:
        local, want = (local,), (want,)
    sh = Sharder(_cpu_mesh(n))
    for B in _sizes(n):
        ia, ib = _pick(B, seed=B)
        got = _sharded(sh, port_fn, (pool, plen, peq), (ia, ib), L=L,
                       win=win)
        assert len(got) == len(local)
        for g, lo, w in zip(got, local, want):
            assert g.dtype == np.int32 and g.shape == (B,)
            np.testing.assert_array_equal(g, lo.numpy()[ia])
            np.testing.assert_array_equal(g, np.asarray(w)[ia])


@pytest.fixture(scope="module")
def wave_data():
    """K5 pairs of up to 124 codes in a 2048-wide pool."""
    q, t, ql, tl = wavefront_code_pairs(5, P, 128, 70)
    wide = lambda x: np.pad(x, ((0, 0), (0, 2048 - 128)), constant_values=7)
    return _pool(wide(q), wide(t), ql, tl, 2048)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("Wp", [128, 256])
def test_sharded_wavefront_matches_local_and_jax(wave_data, n, Wp):
    """At 128 the JAX reference is the Pallas kernel (the engine's small
    band), above it the scan with ``small=False``."""
    pool_flat, plen_np, pool, plen = wave_data
    every = np.arange(P, dtype=np.int32)
    jsh = JaxSharder(jax_make_mesh(n))
    sh = Sharder(_cpu_mesh(n))
    for hw_mode in (False, True):
        local = tw.banded_ed_pool(pool, plen, torch.from_numpy(every),
                                  torch.from_numpy(every + P), Wp=Wp,
                                  hw_mode=hw_mode)
        want = jsh.banded_ed_pool(
            pool_flat, plen_np, _jax_pad(every, 128 * n),
            _jax_pad(every + P, 128 * n), Wp=Wp, L=2048, hw_mode=hw_mode,
            small=False, kernel="pallas" if Wp == 128 else "scan")
        for B in _sizes(n):
            ia, ib = _pick(B, seed=B + hw_mode)
            got = _sharded(sh, tw.banded_ed_pool, (pool, plen), (ia, ib),
                           Wp=Wp, hw_mode=hw_mode)
            assert len(got) == 2
            for g, lo, w in zip(got, local, want):
                np.testing.assert_array_equal(g, lo.numpy()[ia])
                np.testing.assert_array_equal(g, np.asarray(w)[ia])


@pytest.fixture(scope="module")
def align_data():
    pairs, q, qlen, t, tlen, ma, mi, go, ge = affine_inputs(21, P)
    scores = np.stack([ma, mi, go, ge]).astype(np.int32)
    return pairs, scores, _pool(q, t, qlen, tlen, 256)


@pytest.mark.parametrize("n", NS)
def test_sharded_alignment_matches_local_and_jax(align_data, n):
    """The eleven host outputs equal the unsharded wrapper's fetched ones
    (rows trimmed alike); score, endpoints, start and overflow equal the
    JAX Sharder's on all the pool's pairs, and each pair's rows spell its
    alignment, with the JAX decode's counts."""
    pairs, scores, (pool_flat, plen_np, pool, plen) = align_data
    every = _jax_pad(np.arange(P, dtype=np.int32), 128 * n)
    scal, packed = JaxSharder(jax_make_mesh(n)).sg_align_pool(
        pool_flat, plen_np, every, every + P,
        *(_jax_pad(x, 128 * n) for x in scores), Wp=256, L=256)
    scal = np.asarray(scal)
    jops = unpack_ops(np.asarray(packed))
    sh = Sharder(_cpu_mesh(n))
    for B in _sizes(n):
        ia, ib = _pick(B, seed=B)
        sc = [x[ia] for x in scores]
        got = _sharded(sh, tac.sg_align_pool, (pool, plen), (ia, ib, *sc),
                       to_host=tac.fetch, Wp=256)
        local = tac.fetch(tac.sg_align_pool(
            pool, plen, torch.from_numpy(ia), torch.from_numpy(ib),
            *(torch.from_numpy(x) for x in sc), Wp=256))
        assert len(got) == 11
        for g, lo in zip(got, local):
            assert g.dtype == lo.dtype
            np.testing.assert_array_equal(g, lo)
        best, ei, ej, fi, fj, ov, alen, nmat, nmis, a1, a2 = got
        for g, w in zip((best, ei, ej, fi, fj, ov), scal):
            np.testing.assert_array_equal(g.astype(np.int32), w[ia])
        for x in range(B):
            a, b = pairs[ia[x]]
            end = (int(ei[x]), int(ej[x]), int(fi[x]), int(fj[x]))
            want = jax_counts(jops[ia[x]], a, b, *end)
            if not ov[x]:
                A = int(alen[x])
                have = (bytes(a1[x, :A]).decode("latin1"),
                        bytes(a2[x, :A]).decode("latin1"),
                        (int(nmat[x]), int(nmis[x]),
                         A - int(nmat[x]) - int(nmis[x])))
                assert have == want, x
