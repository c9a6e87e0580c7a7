"""The port's embed bag (forward and backward), the backward of its fm
terms and the backward of its ragged gather, held against the JAX
package on the CPU.

The JAX side reaches the Pallas embed-bag kernel in interpret mode
(``embed_bag(..., engine="pallas")``), whose backward is the custom VJP
of ``_embed_bag_pallas_diff``, and the Pallas fm kernel
(``fm_embed_terms(..., engine="pallas")``) with the custom VJP of
``fm_embed_terms``; the flat ops are differentiated with ``jax.grad`` of
``dmlc_core_tpu.ops.csr``.  The port runs its kernels'
plain versions through the same ``torch.autograd.Function`` s that
launch the kernels on the card.

Ids include the out-of-range cases that separate XLA's two rules:
``-1`` (wraps to row F-1 in both directions), ``-F-3`` (reads row 0,
sends no gradient), ``F`` and ``F+7`` (read row F-1, send no gradient).

Tolerances: ``rtol = 1e-5, atol = 1e-6``; both sides sum the same
float32 terms in different orders.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from dmlc_core_tpu.ops import csr as jcsr  # noqa: E402
from dmlc_core_tpu.ops import pallas_embed as jpe  # noqa: E402
from dmlc_core_tpu.ops import ragged_csr as jrag  # noqa: E402
from dmlc_core_tpu_torch import ops as tops  # noqa: E402
from dmlc_core_tpu_torch.kernels import (embed_bag_grad_reference,  # noqa
                                         embed_bag_reference,
                                         fm_terms_grad_reference,
                                         ragged_gather_grad,
                                         ragged_gather_grad_reference)
from dmlc_core_tpu_torch.kernels.common import (clamp_ids,  # noqa: E402
                                                gather_rows, grad_rows)

F = 512
TOL = dict(rtol=1e-5, atol=1e-6)
BAD = [-1, -F - 3, F, F + 7]


@pytest.fixture(autouse=True)
def _no_engine_pin(monkeypatch):
    monkeypatch.delenv("DMLC_EMBED_ENGINE", raising=False)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _rowmajor(rng, B, K, D, bad=True):
    ids = rng.integers(0, F, (B, K)).astype(np.int32)
    if bad:
        ids[0, :4] = BAD[:K]
        if B > 1:
            ids[1, :2] = [F - 1, 0][:K]    # the rows the bad ids read
    vals = rng.normal(size=(B, K)).astype(np.float32)
    ids[2:, K - 2:], vals[2:, K - 2:] = 0, 0.0              # padding
    table = rng.normal(size=(F, D)).astype(np.float32)
    return ids, vals, table


# ---------------------------------------------------------------------------
# the gradient rule (repair of the clamped backward)
# ---------------------------------------------------------------------------

def test_grad_rule_matches_jax_scatter_add():
    ids = np.array([-1, 4, 11, 1, -100, -4, -5, 3], np.int32)
    Fs = 4
    t = np.arange(Fs, dtype=np.float32)
    fwd = np.asarray(jnp.asarray(t)[jnp.asarray(ids)])
    np.testing.assert_array_equal(
        gather_rows(_t(t), _t(ids)).detach().numpy(), fwd)
    g = np.arange(1, len(ids) + 1, dtype=np.float32)
    want = jax.grad(lambda x: jnp.sum(x[jnp.asarray(ids)] * g))(
        jnp.asarray(t))
    tt = _t(t, grad=True)
    (gather_rows(tt, _t(ids)) * _t(g)).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(want))
    # -1 → row 3, 1 → row 1, -4 → row 0, 3 → row 3; the rest drop
    np.testing.assert_array_equal(np.asarray(want), [6, 4, 0, 1 + 8])
    rows = grad_rows(_t(ids), Fs).tolist()
    assert rows == [3, 4, 4, 1, 4, 0, 4, 3]          # 4 = dropped


def test_clamped_autograd_would_disagree_with_jax():
    """Autograd through ``clamp_ids`` (the plain path before the
    two-rule gather) sends out-of-range ids' gradient to the clamped
    row; the custom VJP of the Pallas embed bag does not."""
    rng = np.random.default_rng(0)
    ids, vals, table = _rowmajor(rng, 4, 6, 8)
    g = rng.normal(size=(4, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jpe.embed_bag(
        jnp.asarray(ids), jnp.asarray(vals), t, engine="pallas"),
        jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tt = _t(table, grad=True)
    old = torch.einsum("bk,bkd->bd", _t(vals),
                       tt[clamp_ids(_t(ids), F)])
    (old * _t(g)).sum().backward()
    assert not np.allclose(tt.grad.numpy(), want, **TOL)
    assert not np.allclose(tt.grad.numpy()[[0, F - 1]], want[[0, F - 1]],
                           **TOL)
    tt.grad = None
    (tops.embed_bag(_t(ids), _t(vals), tt) * _t(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# embed bag
# ---------------------------------------------------------------------------

BAG_B = (1, 9, 17)


@functools.lru_cache(maxsize=None)
def _pallas_bags(K, D, square):
    """One batch per B of ``BAG_B`` at this K, D (out-of-range ids in each
    batch's row 0, padding from row 2 on), one shared table, and the
    Pallas embed bag in interpret mode of all of them stacked, cut back
    into the batches: rows are independent, so one interpret-mode
    compile serves the three B (each compile takes seconds).  Values and
    table lie on a coarse dyadic grid, so every partial sum is exact and
    a sum of 65 terms agrees in any order."""
    rng = np.random.default_rng(K * 100 + D)
    table = (rng.integers(-8, 9, (F, D)) / 64).astype(np.float32)
    batches = []
    for B in BAG_B:
        ids, vals, _ = _rowmajor(rng, B, K, D)
        vals = np.where(vals == 0, 0, rng.integers(-8, 9, (B, K)) / 8)
        batches.append((ids, vals.astype(np.float32)))
    want = np.asarray(jpe.embed_bag_pallas(
        jnp.asarray(np.concatenate([i for i, _ in batches])),
        jnp.asarray(np.concatenate([v for _, v in batches])),
        jnp.asarray(table), square=square, interpret=True))
    cuts = np.cumsum((0,) + BAG_B)
    return table, [(i, v, want[a:b]) for (i, v), a, b in
                   zip(batches, cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("D", [1, 8, 32])
@pytest.mark.parametrize("K", [1, 7, 17, 65])
@pytest.mark.parametrize("B", BAG_B)
def test_embed_bag_forward_matches_pallas(B, K, D, square):
    """At the shapes the card's warp-per-row forward branches on: one
    row, a B that is no multiple of the Pallas kernel's 8-row block, K
    below and across a warp iteration and past the k split's threshold."""
    table, batches = _pallas_bags(K, D, square)
    ids, vals, want = batches[BAG_B.index(B)]
    got = tops.embed_bag(_t(ids), _t(vals), _t(table), square=square)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = embed_bag_reference(_t(ids), _t(vals), _t(table), square)
    np.testing.assert_allclose(ref.numpy(), want, **TOL)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("D", [1, 8, 32])
def test_embed_bag_grads_match_custom_vjp(square, D):
    rng = np.random.default_rng(10 + D)
    ids, vals, table = _rowmajor(rng, 16, 8, D)
    g = rng.normal(size=(16, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda v, t: jpe.embed_bag(
        jnp.asarray(ids), v, t, engine="pallas", square=square),
        jnp.asarray(vals), jnp.asarray(table))
    dv, dt = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    v, t = _t(vals, grad=True), _t(table, grad=True)
    got = tops.embed_bag(_t(ids), v, t, square=square)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), dv, **TOL)
    np.testing.assert_allclose(t.grad.numpy(), dt, **TOL)
    # the plain backward alone, and with only one of the two asked for
    gd, gt = embed_bag_grad_reference(_t(ids), _t(vals), _t(table), _t(g),
                                      square)
    np.testing.assert_allclose(gd.numpy(), dv, **TOL)
    np.testing.assert_allclose(gt.numpy(), dt, **TOL)
    t2 = _t(table, grad=True)
    (tops.embed_bag(_t(ids), _t(vals), t2, square=square)
     * _t(g)).sum().backward()
    np.testing.assert_allclose(t2.grad.numpy(), dt, **TOL)


def test_embed_bag_refuses_a_bad_engine_and_bad_shapes():
    from dmlc_core_tpu_torch.utils.logging import DMLCError
    ids = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(DMLCError, match="unknown engine"):
        tops.embed_bag(ids, torch.ones(2, 3), torch.ones(4, 2), engine="x")
    with pytest.raises(DMLCError, match="differ"):
        tops.embed_bag(ids, torch.ones(2, 4), torch.ones(4, 2))
    with pytest.raises(DMLCError, match="needs CUDA"):
        tops.embed_bag(ids, torch.ones(2, 3), torch.ones(4, 2),
                       engine="kernel")


# ---------------------------------------------------------------------------
# fm terms backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 8, 32])
def test_fm_terms_grads_match_custom_vjp(D):
    """``dvals`` and ``dtable`` of the port's ``_FMTerms`` backward (the
    plain version here) against ``jax.vjp`` of the Pallas fm terms, with
    the out-of-range ids and padding."""
    rng = np.random.default_rng(30 + D)
    ids, vals, table = _rowmajor(rng, 16, 8, D)
    table *= 0.3                 # dvals' x² sums of order 1, not D
    g1, g2 = (rng.normal(size=(16, D)).astype(np.float32) for _ in range(2))
    out, vjp = jax.vjp(lambda v, t: jpe.fm_embed_terms(
        jnp.asarray(ids), v, t, engine="pallas"),
        jnp.asarray(vals), jnp.asarray(table))
    dv, dt = (np.asarray(x) for x in vjp((jnp.asarray(g1), jnp.asarray(g2))))
    v, t = _t(vals, grad=True), _t(table, grad=True)
    s1, s2 = tops.fm_embed_terms(_t(ids), v, t)
    for got, want in zip((s1, s2), out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    ((s1 * _t(g1)).sum() + (s2 * _t(g2)).sum()).backward()
    np.testing.assert_allclose(v.grad.numpy(), dv, **TOL)
    np.testing.assert_allclose(t.grad.numpy(), dt, **TOL)
    # the dropped ids sent nothing: rows 0 and F-1 got only their own ids'
    # and -1's gradient, as the JAX scatter-add's
    assert np.abs(dt[F - 1]).max() > 0
    # the plain backward alone, and with only one of the two asked for
    gd, gt = fm_terms_grad_reference(_t(ids), _t(vals), _t(table), _t(g1),
                                     _t(g2))
    np.testing.assert_allclose(gd.numpy(), dv, **TOL)
    np.testing.assert_allclose(gt.numpy(), dt, **TOL)
    only_dv = fm_terms_grad_reference(_t(ids), _t(vals), _t(table), _t(g1),
                                      _t(g2), need_dtable=False)
    only_dt = fm_terms_grad_reference(_t(ids), _t(vals), _t(table), _t(g1),
                                      _t(g2), need_dvals=False)
    assert only_dv[1] is None and only_dt[0] is None
    np.testing.assert_array_equal(only_dv[0].numpy(), gd.numpy())
    np.testing.assert_array_equal(only_dt[1].numpy(), gt.numpy())


def test_fm_terms_clamped_autograd_would_disagree_with_jax():
    """Autograd through a clamped gather sends the out-of-range ids'
    gradient to rows 0 and F-1; the Pallas fm VJP, and the port, drop
    it."""
    rng = np.random.default_rng(6)
    ids, vals, table = _rowmajor(rng, 4, 6, 8)
    g1, g2 = (rng.normal(size=(4, 8)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda t: jpe.fm_embed_terms(
        jnp.asarray(ids), jnp.asarray(vals), t, engine="pallas"),
        jnp.asarray(table))
    want = np.asarray(vjp((jnp.asarray(g1), jnp.asarray(g2)))[0])
    tt = _t(table, grad=True)
    x = tt[clamp_ids(_t(ids), F)]
    s1 = torch.einsum("bk,bkd->bd", _t(vals), x)
    s2 = torch.einsum("bk,bkd->bd", _t(vals) ** 2, x * x)
    ((s1 * _t(g1)).sum() + (s2 * _t(g2)).sum()).backward()
    assert not np.allclose(tt.grad.numpy()[[0, F - 1]], want[[0, F - 1]],
                           **TOL)
    tt.grad = None
    s1, s2 = tops.fm_embed_terms(_t(ids), _t(vals), tt)
    ((s1 * _t(g1)).sum() + (s2 * _t(g2)).sum()).backward()
    np.testing.assert_allclose(tt.grad.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# ragged gather backward, through the flat ops
# ---------------------------------------------------------------------------

def _flat(rng, rows, cap, D):
    counts = rng.integers(0, 9, rows)
    nnz = int(min(counts.sum(), cap))
    ids = np.zeros(cap, np.int32)
    vals = np.zeros(cap, np.float32)
    segs = np.full(cap, rows, np.int32)
    ids[:nnz] = rng.integers(0, F, nnz)
    ids[:4] = BAD
    vals[:nnz] = rng.normal(size=nnz).astype(np.float32)
    segs[:nnz] = np.repeat(np.arange(rows), counts)[:nnz]
    table = (rng.normal(size=(F, D)) * 0.3).astype(np.float32)
    return ids, vals, segs, table


def _flat_padded(rng, rows, D, pad=400, hot=5):
    """A batch as the native packer leaves it, with a hot id: every row
    holds id ``hot`` and 1-8 others, then ``pad`` padding entries (id 0,
    value 0, the scratch segment), so gradient row 0 gets hundreds of
    entries and row ``hot`` one from every row."""
    counts = rng.integers(1, 9, rows)
    nnz = int(counts.sum()) + rows
    cap = nnz + pad
    ids = np.zeros(cap, np.int32)
    vals = np.zeros(cap, np.float32)
    segs = np.full(cap, rows, np.int32)
    ids[:nnz] = rng.integers(1, F, nnz)
    segs[:nnz] = np.repeat(np.arange(rows), counts + 1)
    first = np.r_[0, np.cumsum(counts + 1)[:-1]]
    ids[first] = hot
    ids[np.setdiff1d(np.arange(nnz), first)[:4]] = BAD
    vals[:nnz] = rng.normal(size=nnz).astype(np.float32)
    table = (rng.normal(size=(F, D)) * 0.3).astype(np.float32)
    return ids, vals, segs, table


def _flat_case(op, D, padded=False):
    return pytest.param(op, D, padded,
                        id=f"{op}-{D}" + ("-padded" if padded else ""))


@pytest.mark.parametrize("op,D,padded", [
    _flat_case("csr_dense_matvec", 1), _flat_case("csr_embed_sum", 1),
    _flat_case("csr_embed_sum", 8), _flat_case("csr_embed_sum", 32),
    _flat_case("fm_pairwise", 8), _flat_case("fm_pairwise", 32),
    # the card's owner-writes backward: D not a multiple of 4, FFM's
    # D = 160, heavy padding on row 0 and a hot id (long rows)
    _flat_case("csr_embed_sum", 3, True),
    _flat_case("csr_embed_sum", 160, True),
    _flat_case("fm_pairwise", 3, True)])
def test_flat_op_grads_match_jax(op, D, padded):
    rng = np.random.default_rng(20 + D)
    rows, cap = 12, 128
    ids, vals, segs, table = (_flat_padded(rng, rows, D) if padded
                              else _flat(rng, rows, cap, D))
    if op == "csr_dense_matvec":
        table = table[:, 0].copy()
    out_shape = (rows,) if op != "csr_embed_sum" else (rows, D)
    g = rng.normal(size=out_shape).astype(np.float32)
    jf = getattr(jcsr, op)

    def jloss(v, t):
        return jnp.sum(jf(jnp.asarray(ids), v, jnp.asarray(segs), t, rows)
                       * jnp.asarray(g))
    dv, dt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vals),
                                             jnp.asarray(table))
    v, t = _t(vals, grad=True), _t(table, grad=True)
    (getattr(tops, op)(_t(ids), v, _t(segs), t, rows) * _t(g)).sum() \
        .backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(dv), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(dt), **TOL)


@pytest.mark.parametrize("D", [1, 8])
@pytest.mark.parametrize("fill", [0, 23, 64])
def test_ragged_embed_grad_matches_jax(fill, D):
    """D = 1 is the linear term's gradient (the card's one-launch path);
    fill 0, partial and full."""
    rng = np.random.default_rng(fill)
    rows, cap = 8, 64
    ids = rng.integers(0, F, cap).astype(np.int32)
    ids[:4] = BAD
    vals = rng.normal(size=cap).astype(np.float32)
    segs = np.sort(rng.integers(0, rows, cap)).astype(np.int32)
    ids[fill:], vals[fill:], segs[fill:] = 2 ** 31 - 1, np.nan, -3
    g = rng.normal(size=(rows, D)).astype(np.float32)
    want = jrag.ragged_embed_grad(jnp.asarray(ids), jnp.asarray(vals),
                                  jnp.asarray(segs), jnp.int32(fill),
                                  jnp.asarray(g), F)
    got = tops.ragged_embed_grad(_t(ids), _t(vals), _t(segs), fill, _t(g), F)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nnz = torch.tensor([fill], dtype=torch.int32)
    got2 = tops.ragged_embed_grad(_t(ids), _t(vals), _t(segs), nnz, _t(g), F)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("segs_bad", [[8, 10, 2 ** 30],
                                      [-1, -3, -100],
                                      [8, -1, -8]])
def test_ragged_embed_grad_clamps_live_segments_as_jax(segs_bad):
    """A live entry whose segment lies outside ``[0, num_rows)`` reads
    ``g_rows`` where the JAX version's ``g_rows[min(seg, num_rows - 1)]``
    reads it: a negative segment counts from the end, then the clamp."""
    rng = np.random.default_rng(11)
    rows, cap, fill, D = 8, 48, 40, 4
    ids = rng.integers(8, F, cap).astype(np.int32)
    vals = rng.normal(size=cap).astype(np.float32)
    segs = np.sort(rng.integers(0, rows, cap)).astype(np.int32)
    segs[[3, 17, 30]] = segs_bad
    ids[[3, 17, 30]] = [5, 6, 7]          # rows that get nothing else
    ids[fill:], vals[fill:], segs[fill:] = 1, np.nan, -2
    g = rng.normal(size=(rows, D)).astype(np.float32)
    want = np.asarray(jrag.ragged_embed_grad(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(segs),
        jnp.int32(fill), jnp.asarray(g), F))
    got = tops.ragged_embed_grad(_t(ids), _t(vals), _t(segs), fill, _t(g),
                                 F).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for i in (3, 17, 30):                # each bad segment's row is read
        assert np.abs(want[ids[i]]).max() > 0


@pytest.mark.parametrize("fm", [False, True])
def test_ragged_gather_grad_plain_pieces(fm):
    """The backward's two outputs, asked for one at a time, equal the
    pair; entries past nnz_used get dvals 0."""
    rng = np.random.default_rng(7)
    rows, cap, n, D = 6, 40, 30, 8
    ids = rng.integers(0, F, cap).astype(np.int32)
    vals = rng.normal(size=cap).astype(np.float32)
    segs = rng.integers(0, rows + 1, cap).astype(np.int32)
    ids[n:], vals[n:], segs[n:] = -9, np.nan, rows + 4
    table = rng.normal(size=(F, D)).astype(np.float32)
    g1, g2 = (_t(rng.normal(size=(rows + 1, D)).astype(np.float32))
              for _ in range(2))
    a = (_t(ids), _t(vals), _t(segs), n, _t(table), g1, g2 if fm else None,
         rows)
    dv, dt = ragged_gather_grad(*a)
    assert torch.isfinite(dv).all() and torch.isfinite(dt).all()
    assert not dv[n:].any()
    only_dv = ragged_gather_grad_reference(*a, need_dtable=False)
    only_dt = ragged_gather_grad_reference(*a, need_dvals=False)
    assert only_dv[1] is None and only_dt[0] is None
    np.testing.assert_array_equal(only_dv[0].numpy(), dv.numpy())
    np.testing.assert_array_equal(only_dt[1].numpy(), dt.numpy())
