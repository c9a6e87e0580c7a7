"""The PyTorch port's sparse ops and kernels' plain versions, held against
the JAX package on the CPU.

The same seeded numpy inputs go through ``dmlc_core_tpu.ops`` (XLA, or
Pallas in interpret mode) and ``dmlc_core_tpu_torch.ops``.  Tolerances:
``rtol = atol = 1e-5`` where the two sum float32 terms in different
orders; ``array_equal`` where the port promises bit-identity (its ragged
and padded plain paths).  The CUDA kernels themselves are held against
these plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from dmlc_core_tpu.ops import csr as jcsr  # noqa: E402
from dmlc_core_tpu.ops import pallas_embed as jpe  # noqa: E402
from dmlc_core_tpu.ops import ragged_csr as jrag  # noqa: E402
from dmlc_core_tpu_torch import ops as tops  # noqa: E402
from dmlc_core_tpu_torch.kernels import (fm_terms,  # noqa: E402
                                         ragged_gather)
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402

F = 4096
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _flat(rng, rows, cap, D, max_k=9):
    """A flat padded batch (pack_flat layout) plus a factor table."""
    counts = rng.integers(0, max_k + 1, rows)
    nnz = int(min(counts.sum(), cap))
    ids = np.zeros(cap, np.int32)
    vals = np.zeros(cap, np.float32)
    segs = np.full(cap, rows, np.int32)
    ids[:nnz] = rng.integers(0, F, nnz)
    vals[:nnz] = rng.normal(size=nnz).astype(np.float32)
    segs[:nnz] = np.repeat(np.arange(rows), counts)[:nnz]
    table = (rng.normal(size=(F, D)) * 0.3).astype(np.float32)
    w = rng.normal(size=F).astype(np.float32)
    return ids, vals, segs, nnz, table, w


def _garbage_tail(ids, vals, segs, nnz, rows):
    """Hostile values past nnz: NaN values, out-of-range segments and
    ids; no result may see them."""
    ids, vals, segs = ids.copy(), vals.copy(), segs.copy()
    ids[nnz:] = 2 ** 31 - 1
    vals[nnz:] = np.nan
    segs[nnz:] = np.where(np.arange(len(segs) - nnz) % 2, -3, rows + 5)
    return ids, vals, segs


# ---------------------------------------------------------------------------
# ops/csr.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [8, 32])
@pytest.mark.parametrize("op", ["csr_dense_matvec", "csr_embed_sum",
                                "fm_pairwise"])
def test_csr_ops_match_jax(op, D):
    rng = np.random.default_rng(D)
    rows, cap = 12, 128
    ids, vals, segs, _, table, w = _flat(rng, rows, cap, D)
    arg = w if op == "csr_dense_matvec" else table
    want = getattr(jcsr, op)(_j(ids), _j(vals), _j(segs), _j(arg), rows)
    got = getattr(tops, op)(_t(ids), _t(vals), _t(segs), _t(arg), rows)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# ops/ragged_csr.py against the xla engine, with garbage tails
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("op", ["ragged_embed_sum", "ragged_fm_pairwise",
                                "ragged_dense_matvec"])
def test_ragged_ops_match_jax_xla(op, fill):
    rng = np.random.default_rng(int(fill * 100))
    rows, cap, D = 10, 256, 8
    ids, vals, segs, _, table, w = _flat(rng, rows, cap, D, max_k=30)
    n = int(fill * cap)
    segs[:n] = np.sort(rng.integers(0, rows, n))
    ids, vals, segs = _garbage_tail(ids, vals, segs, n, rows)
    arg = w if op == "ragged_dense_matvec" else table
    kw = {} if op == "ragged_dense_matvec" else {"engine": "xla"}
    want = getattr(jrag, op)(_j(ids), _j(vals), _j(segs), jnp.int32(n),
                             _j(arg), rows, **kw)
    got = getattr(tops, op)(_t(ids), _t(vals), _t(segs),
                            torch.tensor([n], dtype=torch.int32), _t(arg),
                            rows)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ragged_segment_sum_tolerates_garbage_tails():
    rng = np.random.default_rng(0)
    cap, rows, used = 64, 5, 23
    data = rng.normal(size=(cap, 3)).astype(np.float32)
    segs = np.full(cap, -9, np.int32)
    segs[:used] = rng.integers(0, rows, used)
    data[used:] = np.nan
    want = jrag.ragged_segment_sum(_j(data), _j(segs), jnp.int32(used), rows)
    got = tops.ragged_segment_sum(_t(data), _t(segs), used, rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mask_ragged_and_mask_batch_match_jax():
    rng = np.random.default_rng(1)
    rows, cap, n = 6, 32, 19
    ids, vals, segs, _, _, _ = _flat(rng, rows, cap, 8)
    ids, vals, segs = _garbage_tail(ids, vals, segs, n, rows)
    for g, w in zip(tops.mask_ragged(_t(ids), _t(vals), _t(segs), n, rows),
                    jrag.mask_ragged(_j(ids), _j(vals), _j(segs), n, rows)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batch = {"ids": ids, "vals": vals, "segments": segs,
             "labels": rng.normal(size=rows).astype(np.float32),
             "weights": np.ones(rows, np.float32),
             "nnz_used": np.int32(n), "rows_used": np.int32(4)}
    got = tops.mask_batch({k: _t(np.asarray(v)) for k, v in batch.items()})
    want = jrag.mask_batch({k: _j(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("fill_pct", [1, 10, 50, 100])
def test_ragged_plain_path_bit_identical_to_padded(fill_pct):
    """The port's own contract: on the plain path, ragged ops over a
    garbage-tailed capacity batch give the same bits as the padded ops
    over the same live entries."""
    rng = np.random.default_rng(fill_pct)
    rows, cap, D = 16, 256, 8
    ids, vals, segs, _, table, w = _flat(rng, rows, cap, D, max_k=40)
    n = cap * fill_pct // 100
    segs[:n] = np.sort(rng.integers(0, rows, n))
    ids[n:], vals[n:], segs[n:] = 0, 0.0, rows         # padded convention
    rag = _garbage_tail(ids, vals, segs, n, rows)
    pad = (_t(ids), _t(vals), _t(segs))
    rg = tuple(_t(a) for a in rag)
    pairs = [
        (tops.csr_dense_matvec(*pad, _t(w), rows),
         tops.ragged_dense_matvec(*rg, n, _t(w), rows)),
        (tops.csr_embed_sum(*pad, _t(table), rows),
         tops.ragged_embed_sum(*rg, n, _t(table), rows)),
        (tops.fm_pairwise(*pad, _t(table), rows),
         tops.ragged_fm_pairwise(*rg, n, _t(table), rows)),
    ]
    for padded, ragged in pairs:
        assert np.array_equal(padded.numpy(), ragged.numpy())


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fm", [False, True])
def test_ragged_gather_matches_pallas_interpret(fm):
    rng = np.random.default_rng(2)
    rows, cap, D = 6, 48, 32
    counts = rng.integers(0, 9, rows)
    n = int(counts.sum())
    ids = np.full(cap, 3, np.int32)
    vals = rng.normal(size=cap).astype(np.float32)
    segs = np.full(cap, 2, np.int32)
    ids[:n] = rng.integers(0, F, n)
    segs[:n] = np.repeat(np.arange(rows), counts)
    table = rng.normal(size=(F, D)).astype(np.float32)
    want = jrag._gather_pallas(_j(ids), _j(segs), _j(vals), jnp.int32(n),
                               _j(table), rows, fm=fm, interpret=True)
    want = want if fm else [want]
    got = ragged_gather(_t(ids), _t(vals), _t(segs), n, _t(table), rows,
                        fm=fm)
    for g, w in zip(got, want):
        assert g.shape == (rows + 1, D)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    zero, _ = ragged_gather(_t(ids), _t(vals), _t(segs), 0, _t(table), rows,
                            fm=fm)
    assert (zero.numpy() == 0).all()


def test_fm_terms_matches_pallas_interpret_and_xla():
    rng = np.random.default_rng(5)
    B, K, D = 16, 8, 32
    ids = rng.integers(0, F, (B, K)).astype(np.int32)
    vals = rng.random((B, K)).astype(np.float32)
    table = rng.random((F, D)).astype(np.float32)
    pallas = jpe.fm_terms_pallas(_j(ids), _j(vals), _j(table),
                                 interpret=True)
    xla = jpe.fm_embed_terms(_j(ids), _j(vals), _j(table), engine="xla")
    got = tops.fm_embed_terms(_t(ids), _t(vals), _t(table))
    for g, p, x in zip(got, pallas, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL)
    for square in (False, True):
        np.testing.assert_allclose(
            tops.embed_bag_reference(_t(ids), _t(vals), _t(table),
                                     square=square).numpy(),
            np.asarray(jpe.embed_bag_reference(_j(ids), _j(vals), _j(table),
                                               square=square)), **TOL)


# ---------------------------------------------------------------------------
# out-of-range ids: XLA's gather normalises negatives, then clamps
# ---------------------------------------------------------------------------

_BAD_IDS = np.array([-1, F, F + 7], np.int32)


@pytest.mark.parametrize("op", ["csr_dense_matvec", "csr_embed_sum",
                                "fm_pairwise", "ragged_fm_pairwise",
                                "fm_embed_terms", "embed_bag_reference"])
def test_out_of_range_ids_follow_jax(op):
    rng = np.random.default_rng(7)
    D = 8
    table = rng.normal(size=(F, D)).astype(np.float32)
    w = rng.normal(size=F).astype(np.float32)
    if op in ("fm_embed_terms", "embed_bag_reference"):
        ids = rng.integers(0, F, (4, 5)).astype(np.int32)
        ids[:, :3] = _BAD_IDS
        vals = rng.random((4, 5)).astype(np.float32)
        if op == "fm_embed_terms":
            want = jpe.fm_embed_terms(_j(ids), _j(vals), _j(table),
                                      engine="xla")
            got = tops.fm_embed_terms(_t(ids), _t(vals), _t(table))
        else:
            want = [jpe.embed_bag_reference(_j(ids), _j(vals), _j(table))]
            got = [tops.embed_bag_reference(_t(ids), _t(vals), _t(table))]
        for g, x in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL)
        return
    rows, cap = 3, 12
    ids = np.resize(_BAD_IDS, cap)
    vals = rng.random(cap).astype(np.float32)
    segs = np.repeat(np.arange(rows), cap // rows).astype(np.int32)
    arg = w if op == "csr_dense_matvec" else table
    if op == "ragged_fm_pairwise":
        want = jrag.ragged_fm_pairwise(_j(ids), _j(vals), _j(segs),
                                       jnp.int32(cap), _j(arg), rows,
                                       engine="xla")
        got = tops.ragged_fm_pairwise(_t(ids), _t(vals), _t(segs), cap,
                                      _t(arg), rows)
    else:
        want = getattr(jcsr, op)(_j(ids), _j(vals), _j(segs), _j(arg), rows)
        got = getattr(tops, op)(_t(ids), _t(vals), _t(segs), _t(arg), rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# engine choice and input checks
# ---------------------------------------------------------------------------

def _small():
    ids = torch.zeros(4, dtype=torch.int32)
    vals = torch.ones(4)
    segs = torch.zeros(4, dtype=torch.int32)
    table = torch.ones(8, 4)
    return ids, vals, segs, table


def test_kernel_engine_on_cpu_tensors_raises():
    ids, vals, segs, table = _small()
    with pytest.raises(DMLCError, match="CUDA"):
        ragged_gather(ids, vals, segs, None, table, 2, fm=True,
                      engine="kernel")
    with pytest.raises(DMLCError, match="CUDA"):
        fm_terms(ids.reshape(2, 2), vals.reshape(2, 2), table,
                 engine="kernel")
    with pytest.raises(DMLCError, match="unknown engine"):
        ragged_gather(ids, vals, segs, None, table, 2, fm=True,
                      engine="pallas")


@pytest.mark.parametrize("bad", ["ids_int64", "vals_f64", "noncontiguous",
                                 "length", "nnz_used_dtype"])
def test_ragged_gather_rejects_bad_inputs(bad):
    ids, vals, segs, table = _small()
    nnz = None
    if bad == "ids_int64":
        ids = ids.long()
    elif bad == "vals_f64":
        vals = vals.double()
    elif bad == "noncontiguous":
        table = torch.ones(4, 8).t()
    elif bad == "length":
        segs = segs[:3]
    else:
        nnz = torch.tensor([2], dtype=torch.int64)
    with pytest.raises(DMLCError):
        ragged_gather(ids, vals, segs, nnz, table, 2, fm=False)
