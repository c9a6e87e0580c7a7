"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card.  CUDA kernels have no CPU mode, so every test here is marked
``cuda`` and skips on a host without a card; this file imports no JAX so
that it runs on a card machine that has none.

Tolerance ``rtol = atol = 1e-5``: the ragged gather and the backward
kernels add with atomics in no fixed order (the ragged backward at D > 1
builds each gradient row's list of entries with int atomics, so the
order of a row's sum, and of a long row's float4 atomics, varies from
call to call, and two calls are not held bit-equal), fm_terms and the
embed-bag forward sum in a fixed order (so both are also held bit-equal
from call to call) but not the plain version's.  The autograd
``Function``s are checked with ``torch.autograd.gradcheck`` in float64 on
their plain path (the kernels take float32 only).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dmlc_core_tpu_torch.kernels import (  # noqa: E402
    embed_bag_forward, embed_bag_grad, embed_bag_grad_reference,
    embed_bag_reference, fm_terms, fm_terms_grad, fm_terms_grad_reference,
    fm_terms_reference, launch_counts, ragged_gather, ragged_gather_grad,
    ragged_gather_grad_reference, ragged_gather_reference,
    ragged_gather_table_grad)
from dmlc_core_tpu_torch.models import DeepFM, adam  # noqa: E402
from dmlc_core_tpu_torch.ops import (embed_bag, fm_embed_terms,  # noqa: E402
                                     ragged_embed_grad)

pytestmark = pytest.mark.cuda

F = 4096
TOL = dict(rtol=1e-5, atol=1e-5)
BAD_IDS = [-1, F, F + 7]
BAD_IDS_GRAD = [-1, -F - 3, F, F + 7]     # wrap, drop, drop, drop


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# entries one warp iteration of the ragged gather covers (WarpShape in
# common.cuh): a tile is a whole number of them
RG_STEP = {1: 128, 8: 64, 32: 32, 33: 8, 256: 8}
RG_LAYOUTS = ["unsorted", "sorted", "one_row", "each_own", "empty_rows",
              "long_run"]
RG_FILLS = ["step-1", "step", "step+1", "cap", "many_tiles"]


def _ragged_case(rng, layout, fill, D):
    """(segments, rows, cap, n): ``cap`` is never a multiple of a tile;
    ``n`` (nnz_used) sits on an iteration boundary, next to one, at the
    capacity, or inside a ``cap`` large enough that each warp's tile
    spans several iterations (twice the ~8 warps per SM the launcher
    aims at, on a 132-SM H100)."""
    step = RG_STEP[D]
    cap = (2 * 8 * 132 * step if fill == "many_tiles" else 9 * step) + 5
    n = {"step-1": step - 1, "step": step, "step+1": step + 1,
         "cap": cap, "many_tiles": cap - 3 * step - 1}[fill]
    rows = 16
    if layout == "unsorted":
        segs = rng.integers(0, rows + 1, cap)
    elif layout == "sorted":                   # runs shorter than a tile
        segs = np.sort(rng.integers(0, rows + 1, cap))
    elif layout == "one_row":
        segs = np.full(cap, 3)
    elif layout == "each_own":
        rows = cap
        segs = np.arange(cap)
    elif layout == "empty_rows":               # rows 1-4, 6-15 stay empty
        segs = np.sort(rng.choice([0, 5, rows], cap))
    else:                                      # one run over several tiles
        segs = np.sort(np.concatenate([
            rng.integers(0, 8, cap // 4), np.full(cap // 2, 8),
            rng.integers(9, rows + 1, cap - cap // 4 - cap // 2)]))
    return segs.astype(np.int32), rows, cap, n


@pytest.mark.parametrize("fill", RG_FILLS)
@pytest.mark.parametrize("layout", RG_LAYOUTS)
@pytest.mark.parametrize("fm", [False, True])
@pytest.mark.parametrize("D", [1, 8, 32, 33, 256])
def test_ragged_gather_kernel_matches_plain(dev, fm, D, layout, fill):
    rng = np.random.default_rng(D)
    segs, rows, cap, n = _ragged_case(rng, layout, fill, D)
    ids = rng.integers(0, F, cap).astype(np.int32)
    ids[:3] = BAD_IDS
    vals = rng.normal(size=cap).astype(np.float32)
    table = rng.normal(size=(F, D)).astype(np.float32)
    if fill == "many_tiles":
        # rows of ~10^4-10^5 entries: values on a coarse dyadic grid keep
        # every partial sum exact, so any order of adds agrees to 1e-5
        vals = (rng.integers(-2, 3, cap) / 4).astype(np.float32)
        table = (rng.integers(-4, 5, (F, D)) / 64).astype(np.float32)
    vals[rng.random(cap) < 0.1] = 0.0                       # padding-like
    ids[n:], vals[n:] = 2 ** 31 - 1, np.nan                 # garbage tail
    segs[n:] = -3
    segs[n // 2] = rows + 4                                 # dropped
    args = [torch.from_numpy(a).to(dev) for a in (ids, vals, segs)]
    nnz = torch.tensor([n], dtype=torch.int32, device=dev)
    tab = torch.from_numpy(table).to(dev)
    before = launch_counts().get(
        "ragged_gather_fm" if fm else "ragged_gather_embed", 0)
    got = ragged_gather(*args, nnz, tab, rows, fm=fm)
    want = ragged_gather_reference(*args, nnz, tab, rows, fm=fm)
    for g, w in zip(got, want):
        if g is not None:
            torch.testing.assert_close(g, w, **TOL)
    assert launch_counts()["ragged_gather_fm" if fm
                           else "ragged_gather_embed"] == before + 1
    zero, _ = ragged_gather(*args, torch.zeros_like(nnz), tab, rows, fm=fm)
    assert not bool(zero.any())
    # a NaN in a live entry reaches its row
    args[1][1] = float("nan")
    got, _ = ragged_gather(*args, nnz, tab, rows, fm=fm)
    assert bool(got[int(segs[1])].isnan().all())


FM_SHAPES = [(B, K) for B in (1, 127, 128, 4097) for K in (1, 7, 64, 65, 200)]


@pytest.mark.parametrize("B,K", FM_SHAPES)
@pytest.mark.parametrize("D", [8, 32, 33, 40, 256])
def test_fm_terms_kernel_matches_plain(dev, D, B, K):
    rng = np.random.default_rng(12)
    ids = rng.integers(0, F, (B, K)).astype(np.int32)
    ids[:, :3] = BAD_IDS[:K]
    vals = rng.random((B, K)).astype(np.float32)
    table = rng.random((F, D)).astype(np.float32)
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, table)]
    got = fm_terms(*a)
    for g, w in zip(got, fm_terms_reference(*a)):
        torch.testing.assert_close(g, w, **TOL)
    # the order of every sum is fixed: a second call is bit-equal
    for g, h in zip(got, fm_terms(*a)):
        assert torch.equal(g, h)


def _count(name):
    return launch_counts().get(name, 0)


def _rowmajor(rng, dev, B, K, D):
    """ids/vals [B, K] with out-of-range ids, padding entries (id 0,
    value 0) and a table [F, D]."""
    ids = rng.integers(0, F, (B, K)).astype(np.int32)
    vals = rng.normal(size=(B, K)).astype(np.float32)
    ids[0, :4] = BAD_IDS_GRAD[:K]
    ids[1:, K // 2:], vals[1:, K // 2:] = 0, 0.0             # padding
    table = rng.normal(size=(F, D)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (ids, vals, table)]


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("B,K", FM_SHAPES)
@pytest.mark.parametrize("D", [1, 8, 32, 33])
def test_embed_bag_kernel_matches_plain(dev, square, D, B, K):
    """The warp-per-row forward over the fm-terms grid: k split at small
    B, iteration boundaries of K, float4 and scalar rows; out-of-range
    ids in row 0, padding (id 0, value 0) in every other row."""
    ids, vals, table = _rowmajor(np.random.default_rng(D), dev, B, K, D)
    before = _count("embed_bag")
    got = embed_bag_forward(ids, vals, table, square)
    torch.testing.assert_close(
        got, embed_bag_reference(ids, vals, table, square), **TOL)
    assert _count("embed_bag") == before + 1
    # the order of every sum is fixed: a second call is bit-equal
    assert torch.equal(got, embed_bag_forward(ids, vals, table, square))


@pytest.mark.parametrize("square", [False, True])
def test_embed_bag_padding_reads_row_zero(dev, square):
    """A padding entry multiplies table row 0 by 0, as the JAX forward
    does: an inf there makes the rows with padding NaN on both paths."""
    ids, vals, table = _rowmajor(np.random.default_rng(9), dev, 64, 40, 32)
    table[0] = float("inf")
    got = embed_bag_forward(ids, vals, table, square)
    want = embed_bag_reference(ids, vals, table, square)
    assert bool(got[1:].isnan().all())
    torch.testing.assert_close(got, want, equal_nan=True, **TOL)


@pytest.mark.parametrize("need_dvals", [False, True])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("D", [1, 8, 32, 33])
def test_embed_bag_grad_kernel_matches_plain(dev, square, need_dvals, D):
    rng = np.random.default_rng(100 + D)
    ids, vals, table = _rowmajor(rng, dev, 16, 8, D)
    g = torch.from_numpy(rng.normal(size=(16, D)).astype(np.float32)).to(dev)
    before = _count("embed_bag_grad")
    got = embed_bag_grad(ids, vals, table, g, square, need_dvals)
    want = embed_bag_grad_reference(ids, vals, table, g, square, need_dvals)
    assert _count("embed_bag_grad") == before + 1
    assert (got[0] is None) == (not need_dvals)
    for a, b in zip(got, want):
        if a is not None:
            torch.testing.assert_close(a, b, **TOL)
    # the dropped ids send nothing: rows F-1 (from -1) only via -1
    assert bool((got[1][F - 3] == want[1][F - 3]).all())


@pytest.mark.parametrize("need_dvals", [False, True])
@pytest.mark.parametrize("fm", [False, True])
@pytest.mark.parametrize("D", [1, 8, 32, 33])
def test_ragged_gather_grad_kernel_matches_plain(dev, fm, need_dvals, D):
    rng = np.random.default_rng(200 + D)
    rows, cap, n = 16, 512, 300
    ids = rng.integers(0, F, cap).astype(np.int32)
    ids[:4] = BAD_IDS_GRAD
    vals = rng.normal(size=cap).astype(np.float32)
    vals[n - 20:n] = 0.0                                    # padding-like
    segs = rng.integers(0, rows + 1, cap).astype(np.int32)  # unsorted
    segs[5] = rows + 3                                      # dropped
    ids[n:], vals[n:], segs[n:] = 2 ** 31 - 1, np.nan, -3   # garbage tail
    table = rng.normal(size=(F, D)).astype(np.float32)
    g1, g2 = (rng.normal(size=(rows + 1, D)).astype(np.float32)
              for _ in range(2))
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, segs)]
    nnz = torch.tensor([n], dtype=torch.int32, device=dev)
    t = [torch.from_numpy(x).to(dev) for x in (table, g1, g2)]
    g2t = t[2] if fm else None
    name = "ragged_gather_grad_fm" if fm else "ragged_gather_grad_embed"
    before = _count(name)
    got = ragged_gather_grad(*a, nnz, t[0], t[1], g2t, rows, need_dvals)
    want = ragged_gather_grad_reference(*a, nnz, t[0], t[1], g2t, rows,
                                        need_dvals)
    assert _count(name) == before + 1
    for x, y in zip(got, want):
        if x is not None:
            assert torch.isfinite(x).all()
            torch.testing.assert_close(x, y, **TOL)
    if need_dvals:
        assert not bool(got[0][n:].any())


D1_CASES = ["unsorted", "nnz_used_0", "cap_0", "segments_out", "odd_F",
            "many_batches"]


@pytest.mark.parametrize("need_dvals", [False, True])
@pytest.mark.parametrize("case", D1_CASES)
def test_ragged_grad_d1_matches_plain(dev, case, need_dvals):
    """The embed backward at D = 1 (the linear term), one cooperative
    launch that zeroes its gradient and scatters into it.  Every case
    follows a freed NaN-filled block of the gradient's size, so a kernel
    that relied on the allocator's memory would show NaN.  Unsorted
    segments; a garbage tail (NaN values, in-range ids and segments) past
    nnz_used; ``many_batches`` gives every thread of the largest grid
    several batches (dyadic data: every sum exact in any order)."""
    rng = np.random.default_rng(400 + D1_CASES.index(case))
    Fc = 4099 if case == "odd_F" else F                # not a multiple of 4
    rows = 16
    cap = {"cap_0": 0, "many_batches": 2_500_000}.get(case, 700)
    n = 0 if case == "nnz_used_0" else cap - cap // 7
    ids = rng.integers(0, Fc, cap).astype(np.int32)
    ids[:min(cap, 4)] = [-1, -Fc - 3, Fc, Fc + 7][:cap]
    vals = rng.normal(size=cap).astype(np.float32)
    segs = rng.integers(0, rows + 1, cap).astype(np.int32)
    table = rng.normal(size=(Fc, 1)).astype(np.float32)
    g1 = rng.normal(size=(rows + 1, 1)).astype(np.float32)
    if case == "segments_out":
        segs = rng.choice(np.array([-5, rows + 1, 2 ** 30], np.int32), cap)
    if case == "many_batches":
        vals = (rng.integers(-2, 3, cap) / 4).astype(np.float32)
        table = (rng.integers(-4, 5, (Fc, 1)) / 64).astype(np.float32)
        g1 = (rng.integers(-4, 5, (rows + 1, 1)) / 64).astype(np.float32)
    vals[rng.random(cap) < 0.1] = 0.0                       # padding-like
    vals[n:] = np.nan                                       # garbage tail
    ids[n:] = rng.integers(0, Fc, cap - n)
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, segs)]
    nnz = torch.tensor([n], dtype=torch.int32, device=dev)
    tab, g = (torch.from_numpy(x).to(dev) for x in (table, g1))
    poison = torch.full((Fc, 1), float("nan"), device=dev)
    del poison
    before = _count("ragged_gather_grad_embed")
    got = ragged_gather_grad(*a, nnz, tab, g, None, rows, need_dvals)
    assert _count("ragged_gather_grad_embed") == before + (cap > 0)
    want = ragged_gather_grad_reference(*a, nnz, tab, g, None, rows,
                                        need_dvals)
    for x, y in zip(got, want):
        if x is not None:
            assert torch.isfinite(x).all()
            torch.testing.assert_close(x, y, **TOL)
    if case in ("nnz_used_0", "cap_0", "segments_out"):
        assert not bool(got[1].any())
        if need_dvals:
            assert not bool(got[0].any())
    # the table-less entry point (ragged_embed_grad's) gives the same
    poison = torch.full((Fc, 1), float("nan"), device=dev)
    del poison
    only = ragged_gather_table_grad(*a, nnz, g, rows, Fc)
    torch.testing.assert_close(only, want[1], **TOL)


OWN_CASES = ["unsorted", "long_row", "each_own", "all_dropped",
             "minus_one", "nnz_used_0", "nnz_used_cap", "cap_0", "odd_F",
             "nan_padding"]


def _owner_case(rng, case, D, fm, dev):
    """Inputs of the owner-writes backward: ``(a, nnz, table, g1, g2,
    rows, F)`` with ``a`` the (ids, vals, segments) tensors.  Segments
    unsorted (one out of range), out-of-range ids, ~10 % values 0 and a
    NaN tail past a partial nnz_used, unless the case says otherwise:
    ``long_row`` is 600 entries (30 % of them hot id 7) and 10,000 of
    padding (id 0, value 0, the scratch segment) with nnz_used None, so
    rows 0 and 7 are long; ``each_own`` gives each entry its own segment
    and its own gradient row; ``all_dropped`` only ids that send no
    gradient; ``minus_one`` 20 % ids -1 (read from row 0 by the fm
    variant, added into row F - 1); ``nan_padding`` is ``long_row`` with
    a NaN in the padding's g1 row, which must reach row 0 (and the
    padding's dvals)."""
    Fc = 4099 if case == "odd_F" else F
    rows = 16
    cap = {"cap_0": 0, "long_row": 10_600}.get(case, 700)
    n = {"nnz_used_0": 0, "nnz_used_cap": cap}.get(case, cap - cap // 7)
    ids = rng.integers(0, Fc, cap).astype(np.int32)
    ids[:min(cap, 4)] = [-1, -Fc - 3, Fc, Fc + 7][:cap]
    vals = rng.normal(size=cap).astype(np.float32)
    vals[rng.random(cap) < 0.1] = 0.0
    segs = rng.integers(0, rows + 1, cap).astype(np.int32)
    if cap:
        segs[min(5, cap - 1)] = rows + 3                  # dropped
    if case in ("long_row", "nan_padding"):
        ids[:600][rng.random(600) < 0.3] = 7
        ids[600:], vals[600:], segs[600:] = 0, 0.0, rows
        n = None
    elif case == "each_own":
        rows = cap
        segs = np.arange(cap, dtype=np.int32)
        ids = rng.permutation(Fc)[:cap].astype(np.int32)
    elif case == "all_dropped":
        ids = rng.choice(np.array([Fc, Fc + 7, -Fc - 3], np.int32), cap)
    elif case == "minus_one":
        ids[rng.random(cap) < 0.2] = -1
    if n is not None:
        vals[n:] = np.nan                                 # garbage tail
    table = rng.normal(size=(Fc, D)).astype(np.float32)
    g1, g2 = (rng.normal(size=(rows + 1, D)).astype(np.float32)
              for _ in range(2))
    if case == "nan_padding":
        g1[rows, D // 2] = np.nan
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, segs)]
    nnz = (None if n is None
           else torch.tensor([n], dtype=torch.int32, device=dev))
    t = [torch.from_numpy(x).to(dev) for x in (table, g1, g2)]
    return a, nnz, t[0], t[1], (t[2] if fm else None), rows, Fc


def _term_sizes(a, nnz, table, g1, g2, rows, need_dvals=True):
    """The plain backward on the inputs' magnitudes: for every element of
    dvals and dtable, the sum of its terms' sizes (an upper bound)."""
    ids, vals, segs = a
    return ragged_gather_grad_reference(
        ids, vals.abs(), segs, nnz, table.abs(), g1.abs(),
        None if g2 is None else g2.abs(), rows, need_dvals)


def _sums_close(got, want, sizes):
    """``|got - want| <= atol + rtol * sizes`` (TOL's rtol and atol): a
    float32 sum taken in another order differs by rounding relative to
    the size of its terms, not of the sum, which at D = 640 and along
    rows of hundreds of entries may cancel to far less.  NaN where the
    plain version has NaN, and only there."""
    for x, y, z in zip(got, want, sizes):
        if x is None:
            continue
        nan = y.isnan()
        assert torch.equal(x.isnan(), nan)
        x, y, z = x[~nan], y[~nan], z[~nan]
        assert torch.isfinite(x).all()
        err = (x - y).abs()
        bad = err > TOL["atol"] + TOL["rtol"] * z
        assert not bool(bad.any()), (
            f"{int(bad.sum())} elements beyond rtol=atol=1e-5 of their "
            f"terms' sizes; max |err| {float(err.max()):.3g}")


@pytest.mark.parametrize("need_dvals", [False, True])
@pytest.mark.parametrize("fm", [False, True])
@pytest.mark.parametrize("case", OWN_CASES)
@pytest.mark.parametrize("D", [2, 8, 32, 33, 160, 640])
def test_ragged_grad_owner_writes_match_plain(dev, D, case, fm, need_dvals):
    """The backward at D > 1 and the fm variant: each gradient row
    written once by its owner (zeros included), rows of more than 32
    entries zeroed and then added into by 16-byte atomics (scalar ones
    at D 2 and 33).  Every call follows a freed NaN-filled block of the gradient's
    size, so a row left unwritten would show NaN; rows that no entry
    reaches must be exact zeros.  Held within rtol = atol = 1e-5 of each
    element's terms' sizes (``_sums_close``)."""
    rng = np.random.default_rng(
        500 + 37 * OWN_CASES.index(case) + D + 7 * fm)
    a, nnz, table, g1, g2, rows, Fc = _owner_case(rng, case, D, fm, dev)
    cap = a[0].shape[0]
    poison = torch.full((Fc, D), float("nan"), device=dev)
    del poison
    name = "ragged_gather_grad_fm" if fm else "ragged_gather_grad_embed"
    before = _count(name)
    got = ragged_gather_grad(*a, nnz, table, g1, g2, rows, need_dvals)
    assert _count(name) == before + (cap > 0)
    want = ragged_gather_grad_reference(*a, nnz, table, g1, g2, rows,
                                        need_dvals)
    _sums_close(got, want, _term_sizes(a, nnz, table, g1, g2, rows,
                                       need_dvals))
    ids, _, segs = (x.cpu().numpy() for x in a)
    n = cap if nnz is None else int(nnz.item())
    rr = np.where(ids[:n] < 0, ids[:n] + Fc, ids[:n])
    live = (segs[:n] >= 0) & (segs[:n] <= rows) & (rr >= 0) & (rr < Fc)
    untouched = np.ones(Fc, bool)
    untouched[rr[live]] = False
    assert not bool(got[1][torch.from_numpy(untouched).to(dev)].any())
    if case in ("nnz_used_0", "cap_0"):
        assert not bool(got[1].any())
        if need_dvals:
            assert not bool(got[0].any())
    if need_dvals and nnz is not None:
        assert not bool(got[0][n:].any())
    if case in ("long_row", "nan_padding"):
        assert int(np.bincount(rr[live], minlength=Fc).max()) > 32
    if case == "nan_padding":
        assert bool(got[1][0].isnan().any())


@pytest.mark.parametrize("fm", [False, True])
def test_ragged_grad_owner_writes_replay_in_a_cuda_graph(dev, fm):
    """The owner-writes backward captured in a CUDA graph (its workspace
    from the graph's pool, nnz_used read on the device): new ids, values,
    segments and nnz_used copied into the static inputs, then a replay,
    match the plain version on the new inputs, long rows included (within
    ``_sums_close``: a hot id's row sums a thousand entries)."""
    D, rows, cap = 32, 64, 12_000
    rng = np.random.default_rng(61 + fm)

    def batch(n, hot):
        ids = rng.integers(0, F, cap).astype(np.int32)
        ids[:4] = BAD_IDS_GRAD
        ids[:n][rng.random(n) < 0.2] = hot
        vals = rng.normal(size=cap).astype(np.float32)
        segs = rng.integers(0, rows + 1, cap).astype(np.int32)
        ids[n:], vals[n:], segs[n:] = 0, 0.0, rows          # padding
        return [torch.from_numpy(x).to(dev) for x in (ids, vals, segs)]

    static = batch(3000, 11)
    nnz = torch.tensor([cap], dtype=torch.int32, device=dev)
    table, g1, g2 = (torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev) for shape in ((F, D), (rows + 1, D),
                                           (rows + 1, D)))
    g2 = g2 if fm else None
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        ragged_gather_grad(*static, nnz, table, g1, g2, rows)   # warm-up
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ragged_gather_grad(*static, nnz, table, g1, g2, rows)
    for n, hot, used in ((5000, 3, cap), (777, 9, 2000), (cap, 0, cap - 5)):
        new = batch(n, hot)
        for dst, src in zip(static, new):
            dst.copy_(src)
        nnz.fill_(used)
        graph.replay()
        torch.cuda.synchronize()
        want = ragged_gather_grad_reference(*new, nnz, table, g1, g2, rows)
        _sums_close(out, want, _term_sizes(new, nnz, table, g1, g2, rows))


def _shard_plan(mode):
    """Rank 1's plan of two over mp in ``mode``: rows mode owns rows
    [F/2, F); dim mode keeps every row (its columns are the table's)."""
    from dmlc_core_tpu_torch.models import ShardPlan
    rows = (F // 2, F) if mode == "rows" else (0, F)
    return ShardPlan(None, mode, {"v": "mp:0" if mode == "rows"
                                  else "mp:1"}, F, rows)


@pytest.mark.parametrize("mode", ["dim", "rows"])
@pytest.mark.parametrize("fm", [False, True])
@pytest.mark.parametrize("D", [8, 16, 80])
def test_ragged_kernels_at_shard_shapes_match_plain(dev, D, fm, mode):
    """The ragged gather forward and backward as a sharded model calls
    them: dim mode at D = 16 (FM's 32 over mp = 2), 8 and 80 (FFM's
    nf·d/mp); rows mode on rows [F/2, F) of the table, the batch
    remapped by ``ShardPlan.local`` (the other rank's entries inert on
    the scratch row, ids past the table kept for the forward only)."""
    rng = np.random.default_rng(300 + D + fm)
    rows, cap = 64, 4096
    ids = rng.integers(0, F, cap).astype(np.int32)
    ids[:4] = BAD_IDS_GRAD
    vals = rng.normal(size=cap).astype(np.float32)
    segs = np.sort(rng.integers(0, rows + 1, cap)).astype(np.int32)
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, segs)]
    plan = _shard_plan(mode)
    a = list(plan.local(*a, rows))
    Ft = plan.rows[1] - plan.rows[0]
    tab = torch.from_numpy(rng.normal(size=(Ft, D)).astype(np.float32)
                           ).to(dev)
    got = ragged_gather(*a, None, tab, rows, fm=fm)
    want = ragged_gather_reference(*a, None, tab, rows, fm=fm)
    for g, w in zip(got, want):
        if g is not None:
            torch.testing.assert_close(g, w, **TOL)
    g1, g2 = (torch.from_numpy(rng.normal(size=(rows + 1, D)).astype(
        np.float32)).to(dev) for _ in range(2))
    g2 = g2 if fm else None
    got = ragged_gather_grad(*a, None, tab, g1, g2, rows, False)
    want = ragged_gather_grad_reference(*a, None, tab, g1, g2, rows, False)
    torch.testing.assert_close(got[1], want[1], **TOL)


@pytest.mark.parametrize("mode", ["dim", "rows"])
@pytest.mark.parametrize("D", [8, 16])
def test_rowmajor_kernels_at_shard_shapes_match_plain(dev, D, mode):
    """The fm-terms and embed-bag kernels, forward and backward, as a
    sharded row-major model calls them (dim mode: D = 16 or 8; rows
    mode: rows [F/2, F), the other rank's entries of value 0)."""
    rng = np.random.default_rng(400 + D)
    B, K = 256, 64
    ids = torch.from_numpy(rng.integers(0, F, (B, K)).astype(
        np.int32)).to(dev)
    vals = torch.from_numpy(rng.random((B, K), dtype=np.float32)).to(dev)
    plan = _shard_plan(mode)
    ids, vals, _ = plan.local(ids, vals)
    Ft = plan.rows[1] - plan.rows[0]
    tab = torch.from_numpy(rng.normal(size=(Ft, D)).astype(np.float32)
                           ).to(dev)
    for g, w in zip(fm_terms(ids, vals, tab), fm_terms_reference(ids, vals,
                                                                 tab)):
        torch.testing.assert_close(g, w, **TOL)
    torch.testing.assert_close(embed_bag_forward(ids, vals, tab),
                               embed_bag_reference(ids, vals, tab), **TOL)
    g1, g2 = (torch.from_numpy(rng.normal(size=(B, D)).astype(
        np.float32)).to(dev) for _ in range(2))
    torch.testing.assert_close(
        fm_terms_grad(ids, vals, tab, g1, g2, False)[1],
        fm_terms_grad_reference(ids, vals, tab, g1, g2, False)[1], **TOL)
    torch.testing.assert_close(
        embed_bag_grad(ids, vals, tab, g1, False, False)[1],
        embed_bag_grad_reference(ids, vals, tab, g1, False, False)[1],
        **TOL)


def test_ragged_embed_grad_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    rows, cap, n, D = 8, 64, 40, 32
    ids = rng.integers(0, F, cap).astype(np.int32)
    ids[:4] = BAD_IDS_GRAD
    vals = rng.normal(size=cap).astype(np.float32)
    segs = np.sort(rng.integers(0, rows, cap)).astype(np.int32)
    segs[[6, 9, 12]] = [rows + 5, -2, -rows - 4]     # live, clamped
    ids[n:], vals[n:], segs[n:] = -7, np.nan, rows + 2
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, segs)]
    g = torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32))
    got = ragged_embed_grad(*a, n, g.to(dev), F)
    want = ragged_embed_grad(*[x.cpu() for x in a], n, g, F)
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.parametrize("need_dvals", [False, True])
@pytest.mark.parametrize("D", [1, 8, 32, 33])
def test_fm_terms_grad_kernel_matches_plain(dev, need_dvals, D):
    rng = np.random.default_rng(300 + D)
    ids, vals, table = _rowmajor(rng, dev, 16, 8, D)
    g1, g2 = (torch.from_numpy(rng.normal(size=(16, D)).astype(np.float32))
              .to(dev) for _ in range(2))
    before = _count("fm_terms_grad")
    got = fm_terms_grad(ids, vals, table, g1, g2, need_dvals)
    want = fm_terms_grad_reference(ids, vals, table, g1, g2, need_dvals)
    assert _count("fm_terms_grad") == before + 1
    assert (got[0] is None) == (not need_dvals)
    for a, b in zip(got, want):
        if a is not None:
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, **TOL)
    only_dv = fm_terms_grad(ids, vals, table, g1, g2, need_dtable=False)
    assert only_dv[1] is None
    torch.testing.assert_close(only_dv[0], want[0] if need_dvals else
                               fm_terms_grad_reference(ids, vals, table, g1,
                                                       g2)[0], **TOL)


def test_ragged_gather_and_fm_terms_have_a_backward(dev):
    rng = np.random.default_rng(4)
    ids = torch.tensor([1, 2, -1, F + 7], dtype=torch.int32, device=dev)
    segs = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    vals = torch.ones(4, device=dev)
    table = torch.from_numpy(rng.normal(size=(F, 4)).astype(np.float32))
    for fm in (False, True):
        grads = []
        for engine in ("kernel", "torch"):
            t = table.to(dev).requires_grad_()
            o1, o2 = ragged_gather(ids, vals, segs, None, t, 2, fm=fm,
                                   engine=engine)
            (o1.sum() + (o2.sum() if fm else 0)).backward()
            grads.append(t.grad)
        torch.testing.assert_close(grads[0], grads[1], **TOL)
    grads = []
    for engine in ("kernel", "torch"):
        t = table.to(dev).requires_grad_()
        v = vals.reshape(2, 2).clone().requires_grad_()
        s1, s2 = fm_embed_terms(ids.reshape(2, 2), v, t, engine=engine)
        (s1.sum() + 3.0 * s2.sum()).backward()
        grads.append((v.grad, t.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


def _deepfm_step(dev, layout, engine):
    """One DeepFM loss, backward and Adam step on a seeded batch: the
    loss, the gradients and the stepped parameters."""
    rng = np.random.default_rng(21)
    B, K, D = 32, 12, 32
    ids = rng.integers(-2, F + 4, (B, K)).astype(np.int32)
    vals = rng.random((B, K)).astype(np.float32)
    ids[:, K - 3:], vals[:, K - 3:] = 0, 0.0                 # padding
    labels = (rng.random(B) < 0.5).astype(np.float32)
    batch = {"labels": labels, "weights": np.ones(B, np.float32)}
    if layout == "rowmajor":
        batch.update(ids=ids, vals=vals)
    else:
        batch.update(ids=ids.reshape(-1), vals=vals.reshape(-1),
                     segments=np.repeat(np.arange(B, dtype=np.int32), K))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in batch.items()}
    model = DeepFM(F, D, 2, l2=1e-4, init_scale=0.3, engine=engine,
                   device=dev, generator=torch.Generator(dev).manual_seed(5))
    opt = adam(model, 1e-2)
    loss = model.loss(batch)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    opt.step()
    return loss.detach(), grads, {k: p.detach() for k, p in
                                  model.named_parameters()}


@pytest.mark.parametrize("layout", ["rowmajor", "flat"])
def test_deepfm_step_kernel_matches_plain(dev, layout):
    name = "fm_terms_grad" if layout == "rowmajor" else "ragged_gather_grad_fm"
    before = _count(name)
    lk, gk, pk = _deepfm_step(dev, layout, "kernel")
    assert _count(name) == before + 1
    lp, gp, pp = _deepfm_step(dev, layout, "torch")
    torch.testing.assert_close(lk, lp, **TOL)
    for k in gp:
        scale = float(gp[k].abs().max())
        assert scale > 0, k
        assert float((gk[k] - gp[k]).abs().max()) <= 1e-4 * scale, k
        torch.testing.assert_close(pk[k], pp[k], rtol=1e-5, atol=1e-5)


def _gradcheck_inputs(dev):
    rng = np.random.default_rng(5)
    Fs, D = 6, 3
    table = torch.from_numpy(rng.normal(size=(Fs, D))).to(dev)
    return rng, Fs, D, table.requires_grad_()


@pytest.mark.parametrize("square", [False, True])
def test_embed_bag_function_gradcheck_plain_f64(dev, square):
    rng, Fs, D, table = _gradcheck_inputs(dev)
    # ids where the forward and backward rules agree (finite differences
    # see the clamped read; the dropped gradient is by design)
    ids = torch.tensor([[0, 5, -1], [4, -6, 2]], dtype=torch.int32,
                       device=dev)
    vals = torch.from_numpy(rng.normal(size=(2, 3))).to(dev)
    vals.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v, t: embed_bag(ids, v, t, engine="torch", square=square),
        (vals, table))


@pytest.mark.parametrize("fm", [False, True])
def test_ragged_gather_function_gradcheck_plain_f64(dev, fm):
    rng, Fs, D, table = _gradcheck_inputs(dev)
    ids = torch.tensor([0, 5, -1, -Fs, 2, 1], dtype=torch.int32,
                       device=dev)
    segs = torch.tensor([0, 1, 1, 2, 3, 0], dtype=torch.int32, device=dev)
    vals = torch.from_numpy(rng.normal(size=6)).to(dev).requires_grad_()

    def f(v, t):
        o1, o2 = ragged_gather(ids, v, segs, 5, t, 2, fm=fm, engine="torch")
        return (o1, o2) if fm else o1
    assert torch.autograd.gradcheck(f, (vals, table))


def test_fm_terms_function_gradcheck_plain_f64(dev):
    rng, Fs, D, table = _gradcheck_inputs(dev)
    ids = torch.tensor([[0, 5, -1], [4, -6, 2]], dtype=torch.int32,
                       device=dev)
    vals = torch.from_numpy(rng.normal(size=(2, 3))).to(dev)
    vals.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v, t: fm_embed_terms(ids, v, t, engine="torch"),
        (vals, table))


# -- the host feed on the card -------------------------------------------------

def _feed_file(path, rows=1037, seed=5):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(rows):
            n = int(rng.integers(5, 40))
            idx = np.sort(rng.choice(1_000_000, size=n, replace=False))
            f.write(b"%d " % (i & 1) + b" ".join(
                b"%d:%.4f" % (j, v) for j, v in
                zip(idx.tolist(), rng.random(n).tolist())) + b"\n")
    return str(path)


FEED_CASES = {
    "native": dict(),
    "native_pool": dict(put_threads=3),
    "streampack": dict(parser=dict(threaded=False, nthreads=1)),
    "python_flat": dict(engine="python"),
    "rowmajor": dict(layout="rowmajor"),
    "ragged": dict(ragged=True),
}


def _feed(path, device, kw, epochs=2, stream=None):
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.pipeline import DeviceLoader
    kw = dict(kw)
    parser = kw.pop("parser", {})
    cap = 64 if kw.get("layout") == "rowmajor" else 4096
    out, sums = [], []
    with DeviceLoader(create_parser(path, engine="native", **parser), 128,
                      cap, device=device, **kw) as ld, \
            torch.cuda.stream(stream):
        for e in range(epochs):
            if e:
                ld.before_first()
            for b in ld:
                out.append(b)
                if stream is not None:
                    sums.append(b["vals"].double().sum())
    return out, sums


@pytest.mark.parametrize("case", sorted(FEED_CASES))
def test_loader_on_the_card_matches_the_cpu(dev, tmp_path, case):
    """Batches the card receives (held until the end, while the loader
    recycles its pinned buffers and the allocator its blocks) equal the
    CPU loader's; ragged batches on their live prefix."""
    path = _feed_file(tmp_path / "d.libsvm")
    card, _ = _feed(path, "cuda", FEED_CASES[case])
    torch.cuda.synchronize()
    cpu, _ = _feed(path, "cpu", FEED_CASES[case])
    assert len(card) == len(cpu) == 18
    for c, w in zip(card, cpu):
        assert set(c) == set(w)
        for k in w:
            assert c[k].device.type == "cuda"
            got, want = c[k].cpu(), w[k]
            if "nnz_used" in w and k in ("ids", "vals", "segments"):
                n = int(w["nnz_used"])
                got, want = got[:n], want[:n]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert torch.equal(got, want), (case, k)


def test_loader_batches_are_ready_on_the_consumers_stream(dev, tmp_path):
    """A consumer on a stream of its own reads each batch after its copy
    and decode: the sums it takes there equal the CPU's."""
    path = _feed_file(tmp_path / "d.libsvm", seed=6)
    side = torch.cuda.Stream()
    _, sums = _feed(path, "cuda", {}, stream=side)
    cpu, _ = _feed(path, "cpu", {})
    side.synchronize()
    want = [b["vals"].double().sum() for b in cpu]
    assert len(sums) == len(want)
    for s, w in zip(sums, want):
        assert float(s) == float(w)


# -- the fused optimizers and the k-step graphs ----------------------------------

# Optimizer kernels against their plain versions after 8 steps: the same
# float32 operations in the same order, each rounded on its own, so they
# differ only where PyTorch's CUDA ops round differently (a division by a
# Python scalar becomes a multiply by its reciprocal): rtol 1e-6.
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _opt_tensors(dev, layout, seed=9):
    """Parameter-shaped tensors: a 0-d leaf, a short vector, a tail that
    is no multiple of 4, a matrix; ``offset`` starts each one float past
    a 16-byte boundary (no float4), ``many`` has more tensors than one
    launch takes."""
    from dmlc_core_tpu_torch.kernels.optim import MAX_TENSORS
    rng = np.random.default_rng(seed)
    shapes = [(), (7,), ((1 << 16) + 3,), (1000, 32)]
    if layout == "many":
        shapes = shapes * (MAX_TENSORS // len(shapes) + 2)
    out = []
    for s in shapes:
        a = rng.normal(size=s).astype(np.float32)
        if layout == "offset":
            buf = torch.empty(a.size + 1, device=dev)
            t = buf[1:].view(s)
            t.copy_(torch.from_numpy(a))
        else:
            t = torch.from_numpy(a).to(dev)
        out.append(t)
    return out


def _opt_grads(dev, params, step):
    rng = np.random.default_rng(100 + step)
    gs = []
    for p in params:
        g = rng.normal(size=tuple(p.shape)).astype(np.float32)
        g *= 10.0 ** rng.integers(-9, 2, size=g.shape)
        gs.append(torch.from_numpy(np.asarray(g, np.float32)).to(dev))
    return gs


@pytest.mark.parametrize("layout", ["aligned", "offset", "many"])
@pytest.mark.parametrize("which", ["adam", "ftrl"])
def test_optimizer_kernel_matches_plain(dev, which, layout):
    from dmlc_core_tpu_torch.kernels.optim import (adam_step,
                                                   adam_step_reference,
                                                   ftrl_step,
                                                   ftrl_step_reference)
    runs = {}
    for engine in ("kernel", "torch"):
        ps = _opt_tensors(dev, layout)
        s1 = [torch.zeros_like(p) for p in ps]
        s2 = [torch.zeros_like(p) for p in ps]
        count = torch.zeros((), dtype=torch.int32, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        for step in range(8):
            gs = _opt_grads(dev, ps, step)
            if which == "adam" and engine == "kernel":
                adam_step(ps, gs, s1, s2, count, ticket, lr=1e-2,
                          engine="kernel")
            elif which == "adam":
                adam_step_reference(ps, gs, s1, s2, count, lr=1e-2)
            elif engine == "kernel":
                ftrl_step(ps, gs, s1, s2, l1=0.5, engine="kernel")
            else:
                ftrl_step_reference(ps, gs, s1, s2, alpha=0.1, beta=1.0,
                                    l1=0.5, l2=1.0)
        torch.cuda.synchronize()
        runs[engine] = (ps, s1, s2, count, ticket)
    (pk, ak, bk, ck, tk), (pp, ap, bp, cp, _) = runs["kernel"], runs["torch"]
    for got, want in zip(pk + ak + bk, pp + ap + bp):
        torch.testing.assert_close(got, want, **OPT_TOL)
    if which == "adam":
        assert int(ck) == int(cp) == 8 and int(tk) == 0
    else:          # the L1 threshold's exact zeros agree
        for got, want in zip(pk, pp):
            assert torch.equal(got == 0, want == 0)


def _kstep_file(path, rows, seed=11):
    """8 values a row, so every 16-row batch falls in one nnz bucket."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(rows):
            n = 8
            idx = np.sort(rng.choice(F, size=n, replace=False))
            f.write(b"%d " % (i & 1) + b" ".join(
                b"%d:%.4f" % (j, v) for j, v in
                zip(idx.tolist(), rng.random(n).tolist())) + b"\n")
    return str(path)


@pytest.mark.parametrize("kind", ["fm", "logreg_ftrl", "deepfm"])
def test_captured_ksteps_match_eager_per_step(dev, tmp_path, kind):
    """FusedTrainer (k=3 over 7 batches: graphs of 3 and 1 steps) against
    the per-step loop on a twin model, on the same batches; a replay
    counts its graph's launches."""
    from dmlc_core_tpu_torch import (FTRL, DeviceLoader, FactorizationMachine,
                                     FusedTrainer, SparseLogReg, adam,
                                     create_parser, make_train_step)
    from dmlc_core_tpu_torch.kernels import reset_launch_counts
    path = _kstep_file(tmp_path / "k.libsvm", 16 * 7)

    def build():
        gen = torch.Generator(dev).manual_seed(3)
        if kind == "fm":
            m = FactorizationMachine(F, 8, l2=1e-4, device=dev,
                                     generator=gen)
        elif kind == "deepfm":
            m = DeepFM(F, 8, 2, device=dev, generator=gen)
        else:
            m = SparseLogReg(F, device=dev)
        opt = (FTRL(m.parameters(), l1=0.01) if kind == "logreg_ftrl"
               else adam(m, 1e-2))
        return m, opt

    model, opt = build()
    with DeviceLoader(create_parser(path, engine="native"), 16, 1024,
                      device=dev, emit="host") as ld:
        tr = FusedTrainer(model, opt, ld, k=3)
        ptrs = [p.data_ptr() for p in model.parameters()]
        reset_launch_counts()
        tr.run_epoch()
        counts = _counts()
    assert tr.steps == 7
    assert sorted(kk for _, kk in tr._kstep_cache) == [1, 3]
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    name = "ftrl" if kind == "logreg_ftrl" else "adam"
    assert counts[name] == 7                     # one launch a step
    assert counts["ragged_gather_grad_embed"] >= 7

    twin, topt = build()
    step = make_train_step(twin, topt)
    losses = []
    with DeviceLoader(create_parser(path, engine="native"), 16, 1024,
                      device=dev) as ld:
        for b in ld:
            losses.append(step(b))
    torch.testing.assert_close(tr.losses, torch.stack(losses[-1:]),
                               rtol=1e-5, atol=1e-6)
    for (k, p), (_, q) in zip(model.named_parameters(),
                              twin.named_parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=k)


def _counts():
    from dmlc_core_tpu_torch.kernels import launch_counts
    return launch_counts()


def test_kbatch_graph_matches_eager(dev):
    from dmlc_core_tpu_torch import FactorizationMachine, adam
    from dmlc_core_tpu_torch.models import (make_train_step,
                                            make_train_step_kbatch,
                                            stack_batches)
    from dmlc_core_tpu_torch.pipeline import pack_flat
    from dmlc_core_tpu_torch.data import RowBlock, parse_libsvm
    rng = np.random.default_rng(4)
    lines = b"\n".join(b"%d " % (i & 1) + b" ".join(
        b"%d:%.3f" % (j, rng.random()) for j in
        np.sort(rng.choice(F, 6, replace=False)).tolist())
        for i in range(16 * 4)) + b"\n"
    d = parse_libsvm(lines)
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                   d["weights"])
    batches = []
    for lo in range(0, 64, 16):
        b = pack_flat(blk.slice(lo, lo + 16), 16, 128)
        b.pop("row_ptr")
        batches.append(b)
    a = FactorizationMachine(F, 8, device=dev,
                             generator=torch.Generator(dev).manual_seed(1))
    b = FactorizationMachine(F, 8, device=dev,
                             generator=torch.Generator(dev).manual_seed(1))
    kstep = make_train_step_kbatch(a, adam(a, 1e-2))
    got = torch.cat([kstep(stack_batches(batches[:2], dev)),
                     kstep(stack_batches(batches[2:], dev))])
    step = make_train_step(b, adam(b, 1e-2))
    want = torch.stack([step({k: torch.from_numpy(v).to(dev)
                              for k, v in x.items()}) for x in batches])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=k)


def test_capture_refuses_a_pageable_copy(dev):
    """An int ``nnz_used`` would cross in a pageable copy: under a
    capture the wrapper raises instead."""
    from dmlc_core_tpu_torch.utils import DMLCError
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    segs = torch.zeros(8, dtype=torch.int32, device=dev)
    vals = torch.ones(8, device=dev)
    table = torch.ones(16, 4, device=dev)
    nnz = torch.tensor([5], dtype=torch.int32, device=dev)
    ragged_gather(ids, vals, segs, nnz, table, 2, fm=False)   # loads it
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(DMLCError, match="while a CUDA graph is capturing"):
        with torch.cuda.graph(g):
            ragged_gather(ids, vals, segs, 5, table, 2, fm=False)


# ---------------------------------------------------------------------------
# serving: one captured CUDA graph a bucket
# ---------------------------------------------------------------------------

SERVE_D = 32


def _serve_params(kind, seed):
    """Seeded numpy weights (the JAX tree) of a FactorizationMachine or
    DeepFM (layers 2) over F features."""
    rng = np.random.default_rng(seed)
    p = {"w0": np.asarray(0.1 * (seed + 1), np.float32),
         "w": (rng.normal(size=F) * 0.1).astype(np.float32),
         "v": (rng.normal(size=(F, SERVE_D)) * 0.05).astype(np.float32)}
    if kind == "deepfm":
        p["tower"] = {"w": (rng.normal(size=(2, SERVE_D, SERVE_D))
                            / np.sqrt(SERVE_D)).astype(np.float32),
                      "b": np.zeros((2, SERVE_D), np.float32)}
        p["head"] = {"w": (rng.normal(size=SERVE_D)
                           / np.sqrt(SERVE_D)).astype(np.float32),
                     "b": np.zeros((), np.float32)}
    return p


def _serve_model(kind, device):
    from dmlc_core_tpu_torch import FactorizationMachine
    if kind == "deepfm":
        return DeepFM(F, SERVE_D, 2, device=device)
    return FactorizationMachine(F, SERVE_D, device=device)


def _serve_engines(dev, kind, ragged, seed=1):
    """The engine on the card and its plain twin on the CPU."""
    from dmlc_core_tpu_torch import InferenceEngine
    p = _serve_params(kind, seed)
    kw = dict(postprocess="sigmoid", ragged=ragged)
    return (InferenceEngine(_serve_model(kind, dev), p, device=dev, **kw),
            InferenceEngine(_serve_model(kind, "cpu"), p, device="cpu",
                            **kw))


def _serve_req(rng, rows, nnz):
    """``rows`` rows holding ``nnz`` entries in all (each row >= 0)."""
    cuts = np.sort(rng.integers(0, nnz + 1, rows - 1))
    row_ptr = np.concatenate([[0], cuts, [nnz]]).astype(np.int64)
    return (rng.integers(0, F, nnz).astype(np.int32),
            rng.random(nnz, dtype=np.float32), row_ptr)


@pytest.mark.parametrize("kind", ["fm", "deepfm"])
@pytest.mark.parametrize("ragged", [False, True])
def test_serving_graph_replay_matches_eager_every_bucket(dev, ragged, kind):
    """Each bucket of both ladders, filled to its size and (ragged) to
    part of it: the replay against the eager kernel path on the same
    padded batch and against the plain path on the CPU."""
    eng, plain = _serve_engines(dev, kind, ragged)
    rng = np.random.default_rng(2)
    for b in eng.ladder:
        for rows, nnz in ((b.rows, b.nnz), (max(1, b.rows // 3),
                                            max(1, b.nnz // 5))):
            req = _serve_req(rng, rows, nnz)
            if rows == b.rows:
                assert eng.ladder.best_fit(rows, nnz) == b
            got = eng.predict(*req)
            fit = eng.ladder.best_fit(rows, nnz)
            eager = eng._forward(eng._params, eng._pad(fit, *req))
            eager = eager.cpu().numpy()[:rows]
            assert got.shape == (rows,) and np.isfinite(got).all()
            np.testing.assert_allclose(got, eager, **TOL)
            np.testing.assert_allclose(got, plain.predict(*req), **TOL)
    assert eng.compile_count == len(eng._graphs) <= len(eng.ladder)


@pytest.mark.parametrize("ragged", [False, True])
def test_serving_compile_count_counts_captured_graphs(dev, ragged):
    from dmlc_core_tpu_torch.serving import RequestTooLarge
    eng, _ = _serve_engines(dev, "fm", ragged)
    eng.warmup_all()
    assert eng.compile_count == len(eng.ladder) == len(eng._graphs)
    rng = np.random.default_rng(3)
    for _ in range(30):
        rows = int(rng.integers(1, 129))
        eng.predict(*_serve_req(rng, rows, int(rng.integers(rows, 8193))))
    eng.warmup_all()
    assert eng.compile_count == len(eng.ladder)
    with pytest.raises(RequestTooLarge):
        eng.predict(*_serve_req(rng, 129, 200))


@pytest.mark.parametrize("ragged", [False, True])
def test_capture_watchdog_and_memory_gauges_on_the_card(dev, ragged,
                                                        monkeypatch):
    """Each captured graph is one ``xla.compile.<bucket>`` (the JAX
    keys), each replay of a graph that was there a hit, a second
    ``warmup_all`` hits only, a request past the ladder a ladder miss;
    ``sample_memory``'s gauges are the allocator's."""
    from dmlc_core_tpu_torch.serving import RequestTooLarge
    from dmlc_core_tpu_torch.telemetry import graph_introspect as gi
    from dmlc_core_tpu_torch.utils.metrics import MetricsRegistry
    reg = MetricsRegistry()
    monkeypatch.setattr(gi, "watchdog", gi.RetraceWatchdog(registry=reg))
    eng, _ = _serve_engines(dev, "fm", ragged)
    eng.warmup_all()
    keys = {gi.bucket_key(b.rows, b.nnz, ragged) for b in eng.ladder}
    snap = reg.snapshot()
    assert {k[len("xla.compile."):] for k in snap
            if k.startswith("xla.compile.")} == keys
    assert snap["xla.compiles"]["value"] == len(eng.ladder)
    assert "xla.cache_hits" not in snap
    rng = np.random.default_rng(4)
    for _ in range(20):
        rows = int(rng.integers(1, 129))
        eng.predict(*_serve_req(rng, rows, int(rng.integers(rows, 8193))))
    eng.warmup_all()
    assert reg.counter("xla.cache_hits").value == 20 + len(eng.ladder)
    assert reg.counter("xla.compiles").value == len(eng.ladder)
    assert not gi.watchdog.alerted
    with pytest.raises(RequestTooLarge):
        eng.predict(*_serve_req(rng, 129, 200))
    assert reg.counter("xla.ladder_misses").value == 1
    assert gi.watchdog.alerted
    torch.cuda.synchronize()
    assert gi.sample_memory(reg)
    stats = torch.cuda.memory_stats(dev)
    assert reg.gauge(f"xla.mem.{dev.index or 0}.bytes_in_use").value == \
        stats["allocated_bytes.all.current"]
    assert reg.gauge(f"xla.mem.{dev.index or 0}.peak_bytes_in_use").value == \
        stats["allocated_bytes.all.peak"]
    assert reg.gauge(f"xla.mem.{dev.index or 0}.bytes_limit").value == \
        torch.cuda.mem_get_info(dev)[1]
    assert reg.gauge("xla.live_buffers").value == stats["active.all.current"]


def test_serving_reload_copies_in_place_and_every_graph_follows(dev,
                                                                tmp_path):
    from dmlc_core_tpu_torch import CheckpointManager, InferenceEngine
    model = _serve_model("fm", dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    eng = InferenceEngine(model, postprocess="sigmoid", device=dev,
                          warmup=True)
    ptrs = {k: v.data_ptr() for k, v in eng._params.items()}
    p2 = _serve_params("fm", 7)
    CheckpointManager(str(tmp_path)).save(2, {"params": p2})
    assert eng.reload_from_checkpoint(str(tmp_path)) == 2
    _, plain = _serve_engines(dev, "fm", False, seed=7)
    rng = np.random.default_rng(4)
    for b in eng.ladder:                  # every captured graph
        req = _serve_req(rng, b.rows, b.nnz)
        np.testing.assert_allclose(eng.predict(*req), plain.predict(*req),
                                   **TOL)
    assert {k: v.data_ptr() for k, v in eng._params.items()} == ptrs
    for k, v in model.state_dict().items():     # the caller's module
        assert torch.equal(v, before[k]), k
    assert eng.compile_count == len(eng.ladder)


@pytest.mark.parametrize("ragged", [False, True])
def test_serving_replay_launches_equal_an_eager_forward(dev, ragged):
    from dmlc_core_tpu_torch.kernels import reset_launch_counts
    eng, _ = _serve_engines(dev, "deepfm", ragged)
    eng.warmup_all()
    rng = np.random.default_rng(5)
    for b in eng.ladder:
        req = _serve_req(rng, b.rows, b.nnz)
        reset_launch_counts()
        eng._forward(eng._params, eng._pad(b, *req))
        torch.cuda.synchronize()
        eager = _counts()
        assert eager and eng._graphs[b].launches == eager
        reset_launch_counts()
        eng.predict(*req)
        assert _counts() == eager


def test_serving_concurrent_predicts_match_plain(dev):
    eng, plain = _serve_engines(dev, "fm", False)
    rng = np.random.default_rng(6)
    reqs = [_serve_req(rng, int(r), int(r) * int(rng.integers(1, 40)))
            for r in rng.integers(1, 129, 64)]
    got = [None] * len(reqs)
    errors = []

    def worker(k):
        try:
            for j in range(k, len(reqs), 8):
                got[j] = eng.predict(*reqs[j])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
        assert not t.is_alive()
    assert errors == []
    for r, g in zip(reqs, got):
        np.testing.assert_allclose(g, plain.predict(*r), **TOL)


def test_server_on_the_card_matches_plain(dev):
    from dmlc_core_tpu_torch import PredictClient, PredictionServer
    eng, plain = _serve_engines(dev, "fm", True)
    rng = np.random.default_rng(8)
    reqs = [_serve_req(rng, int(r), int(r) * 20)
            for r in rng.integers(1, 100, 16)]
    with PredictionServer(eng).start() as srv:
        assert eng.compile_count == len(eng.ladder)
        with PredictClient(srv.host, srv.port) as c:
            futs = [c.submit(*r) for r in reqs]
            for r, f in zip(reqs, futs):
                np.testing.assert_allclose(f.result(timeout=60),
                                           plain.predict(*r), **TOL)


@pytest.mark.parametrize("via", ["engine", "batcher", "server"])
def test_serving_reload_mid_stream_switches_once(dev, tmp_path, via):
    """One request streams from another thread (straight into the engine,
    through a MicroBatcher, or over TCP) while the weights are reloaded:
    no failure, and the answers move from the old scores to the new ones
    exactly once."""
    from dmlc_core_tpu_torch import (CheckpointManager, MicroBatcher,
                                     PredictClient, PredictionServer)
    eng, _ = _serve_engines(dev, "fm", False, seed=1)
    eng.warmup_all()
    _, plain1 = _serve_engines(dev, "fm", False, seed=1)
    _, plain2 = _serve_engines(dev, "fm", False, seed=9)
    CheckpointManager(str(tmp_path)).save(2, {"params": _serve_params(
        "fm", 9)})
    req = _serve_req(np.random.default_rng(10), 32, 900)
    s1, s2 = plain1.predict(*req), plain2.predict(*req)
    srv = batcher = client = None
    if via == "engine":
        call = lambda: eng.predict(*req)  # noqa: E731
    elif via == "batcher":
        batcher = MicroBatcher(eng, max_delay_s=0.0)
        call = lambda: batcher.submit(*req).result(timeout=60)  # noqa: E731
    else:
        srv = PredictionServer(eng).start()
        client = PredictClient(srv.host, srv.port)
        call = lambda: client.predict(*req, timeout=60)  # noqa: E731
    results, failures, stop = [], [], threading.Event()

    def stream():
        while not stop.is_set():
            try:
                results.append(call())
            except Exception as e:  # noqa: BLE001 — asserted below
                failures.append(e)
                return

    t = threading.Thread(target=stream)
    t.start()
    try:
        while len(results) < 30 and not failures:
            time.sleep(0.001)
        before = len(results)
        assert eng.reload_from_checkpoint(str(tmp_path)) == 2
        at = len(results)              # answers done by its return
        while len(results) < at + 30 and not failures:
            time.sleep(0.001)
    finally:
        stop.set()
        t.join(timeout=60)
        if client is not None:
            client.close()
        if srv is not None:
            srv.stop()
        if batcher is not None:
            batcher.close()
    assert not t.is_alive() and failures == []
    steps = [1 if np.allclose(r, s1, **TOL) else
             2 if np.allclose(r, s2, **TOL) else 0 for r in results]
    direct = eng.predict(*req)
    assert steps == sorted(steps) and steps[0] == 1 and 0 not in steps, (
        steps, float(np.abs(direct - s1).max()),
        float(np.abs(direct - s2).max()))
    assert steps[-1] == 2 and before <= steps.index(2) <= at + 1


# -- the field-aware FM: the ragged gather at D = nf * d ---------------------

def _ffm_step(dev, layout, nf, d, engine):
    """One FieldAwareFM loss and backward on a seeded batch with fields
    past nf - 1, out-of-range ids and padding: the loss and the
    gradients."""
    from dmlc_core_tpu_torch.models import FieldAwareFM
    rng = np.random.default_rng(31)
    B, K = 48, 10
    ids = rng.integers(0, F, (B, K)).astype(np.int32)
    ids[0, :4] = BAD_IDS_GRAD
    vals = rng.random((B, K)).astype(np.float32)
    fields = rng.integers(0, nf + 2, (B, K)).astype(np.int32)
    ids[:, K - 3:], vals[:, K - 3:], fields[:, K - 3:] = 0, 0.0, 0
    labels = (rng.random(B) < 0.5).astype(np.float32)
    batch = {"labels": labels, "weights": np.ones(B, np.float32)}
    if layout == "rowmajor":
        batch.update(ids=ids, vals=vals, fields=fields)
    else:
        live = vals != 0
        pad = 7
        batch.update(
            ids=np.concatenate([ids[live], np.zeros(pad, np.int32)]),
            vals=np.concatenate([vals[live], np.zeros(pad, np.float32)]),
            fields=np.concatenate([fields[live], np.zeros(pad, np.int32)]),
            segments=np.concatenate([np.nonzero(live)[0].astype(np.int32),
                                     np.full(pad, B, np.int32)]))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in batch.items()}
    model = FieldAwareFM(F, nf, d, l2=1e-4, init_scale=0.3, engine=engine,
                         device=dev,
                         generator=torch.Generator(dev).manual_seed(7))
    loss = model.loss(batch)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


@pytest.mark.parametrize("nf,d", [(5, 4), (40, 4), (3, 3)])
@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
def test_ffm_step_kernel_matches_plain(dev, layout, nf, d):
    """G and its gradient go through the ragged-gather kernels at
    D = nf * d (float4 rows at d = 4, scalar at 3 x 3 = 9)."""
    before = {k: _count(k) for k in ("ragged_gather_embed",
                                     "ragged_gather_grad_embed")}
    lk, gk = _ffm_step(dev, layout, nf, d, "kernel")
    # flat: the linear term and G, forward and backward; row-major: G
    per = 2 if layout == "flat" else 1
    for k, n in before.items():
        assert _count(k) == n + per, k
    lp, gp = _ffm_step(dev, layout, nf, d, "torch")
    torch.testing.assert_close(lk, lp, **TOL)
    for k in gp:
        scale = float(gp[k].abs().max())
        assert scale > 0, k
        assert float((gk[k] - gp[k]).abs().max()) <= 1e-4 * scale, k


def test_ragged_gather_at_the_ffm_shape_matches_plain(dev):
    """The bench config's bucket sum: D = 40 * 4, segments row * 40 +
    field, unsorted within a row, padding on the scratch row and past
    it; forward and table gradient against their plain versions."""
    rng = np.random.default_rng(33)
    nf, d, rows, Fs = 40, 4, 256, 1 << 14
    counts = rng.integers(5, 40, rows)
    n = int(counts.sum())
    cap = n + 300
    ids = np.zeros(cap, np.int32)
    ids[:n] = rng.integers(0, Fs, n)
    ids[:4] = [-1, -Fs - 3, Fs, Fs + 7]
    vals = np.zeros(cap, np.float32)
    vals[:n] = rng.random(n)
    f = np.zeros(cap, np.int32)
    f[:n] = rng.integers(0, nf, n)
    seg = np.full(cap, rows, np.int32)
    seg[:n] = np.repeat(np.arange(rows, dtype=np.int32), counts)
    segs = seg * nf + f                      # padding: the scratch row
    segs[n + 100:] = rows * nf + 5           # ... and past it
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, segs)]
    table = torch.from_numpy(rng.normal(size=(Fs, nf * d)).astype(
        np.float32)).to(dev)
    got, _ = ragged_gather(*a, None, table, rows * nf, fm=False)
    want, _ = ragged_gather_reference(*a, None, table, rows * nf, fm=False)
    torch.testing.assert_close(got, want, **TOL)
    g1 = torch.from_numpy(rng.normal(size=(rows * nf + 1, nf * d)).astype(
        np.float32)).to(dev)
    got = ragged_gather_table_grad(*a, None, g1, rows * nf, Fs)
    _, want = ragged_gather_grad_reference(*a, None, table, g1, None,
                                           rows * nf, need_dvals=False)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(layout="rowmajor"),
                                dict(ragged=True)],
                         ids=["flat", "rowmajor", "ragged"])
def test_loader_fields_on_the_card_match_the_cpu(dev, tmp_path, kw):
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.pipeline import DeviceLoader
    rng = np.random.default_rng(35)
    path = tmp_path / "d.libfm"
    with open(path, "wb") as f:
        for i in range(300):
            n = int(rng.integers(5, 40))
            idx = np.sort(rng.choice(1_000_000, size=n, replace=False))
            f.write(b"%d " % (i & 1) + b" ".join(
                b"%d:%d:%.4f" % (j % 40, j, v) for j, v in
                zip(idx.tolist(), rng.random(n).tolist())) + b"\n")
    cap = 64 if kw.get("layout") == "rowmajor" else 4096
    out = {}
    for device in ("cuda", "cpu"):
        with DeviceLoader(create_parser(str(path), parser_type="libfm"), 128,
                          cap, device=device, fields=True, **kw) as ld:
            out[device] = [{k: v.cpu() for k, v in b.items()} for b in ld]
    assert len(out["cuda"]) == len(out["cpu"]) >= 3
    for c, w in zip(out["cuda"], out["cpu"]):
        assert set(c) == set(w) and "fields" in w
        for k in w:
            got, want = c[k], w[k]
            if "nnz_used" in w and k in ("ids", "vals", "segments",
                                         "fields"):
                m = int(w["nnz_used"])
                got, want = got[:m], want[:m]
            assert torch.equal(got, want), k


# -- the I/O layer on the card: page replay and asynchronous checkpoints ----

def _within(seconds, fn, *args):
    """Run ``fn(*args)`` on a thread of its own and fail unless it ends
    within ``seconds`` (a hung copy or writer must not hang the run)."""
    box = []

    def run():
        try:
            box.append((fn(*args), None))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box.append((None, e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=seconds)
    assert not t.is_alive(), f"{fn.__name__} took over {seconds} s"
    result, err = box[0]
    if err is not None:
        raise err
    return result


def test_page_replay_on_the_card(dev, tmp_path):
    """Epochs 2 and 3 of a ``dir#cache`` loader come from the page file,
    through pinned pool buffers, equal on the card to epoch 1; the pool
    holds no page view."""
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    d = tmp_path / "d"
    d.mkdir()
    for i in range(3):
        _kstep_file(d / f"p{i}.libsvm", 16 * 5 + 3 * i)
    (d / "empty.libsvm").write_bytes(b"")

    def body():
        # a writer queue of the epoch's 16 batches (249 rows at 16): the
        # build can never be dropped by a writer that falls behind
        with DeviceLoader(create_parser(f"{d}#{tmp_path}/c",
                                        engine="native"), 16, 1024,
                          device=dev, cache_queue_pages=16) as ld:
            epochs = []
            for e in range(3):
                if e:
                    ld.before_first()
                epochs.append([{k: v.clone() for k, v in b.items()}
                               for b in ld])
            assert ld.cache_stats["hits"] == 2
            assert ld.cache_stats["misses"] == 1
            assert all(b.flags.writeable for b in ld._pool._bufs)
            assert all(torch.from_numpy(b).is_pinned()
                       for b in ld._pool._bufs) or dev.type == "cpu"
        for ep in epochs[1:]:
            assert len(ep) == len(epochs[0]) > 0
            for x, y in zip(ep, epochs[0]):
                for k in y:
                    assert torch.equal(x[k], y[k]), k

    _within(120, body)


def _fm_state(model, opt):
    from dmlc_core_tpu_torch.models import adam_state_to_optax
    from dmlc_core_tpu_torch.models.convert import params_tree
    return {"params": params_tree(model),
            "opt_state": adam_state_to_optax(model, opt, host=False)}


def test_save_async_snapshot_before_an_in_place_adam_step(dev, tmp_path):
    """``save_async`` right before the fused Adam step updates the
    parameters and moments in place: the checkpoint holds the state at
    the call, byte for byte that of a synchronous save of a clone taken
    there."""
    from dmlc_core_tpu_torch import (DeviceLoader, FactorizationMachine,
                                     adam, create_parser, make_train_step)
    from dmlc_core_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      snapshot)
    path = _kstep_file(tmp_path / "k.libsvm", 16 * 6)

    def body():
        model = FactorizationMachine(F, 32, device=dev,
                                     generator=torch.Generator(dev)
                                     .manual_seed(1))
        opt = adam(model, 1e-2)
        step = make_train_step(model, opt)
        with DeviceLoader(create_parser(path, engine="native"), 16, 1024,
                          device=dev) as ld:
            batches = list(ld)
        for b in batches[:3]:
            step(b)
        ref = CheckpointManager(str(tmp_path / "ref"))
        clone = snapshot(_fm_state(model, opt))
        mgr = CheckpointManager(str(tmp_path / "async"))
        mgr.save_async(3, _fm_state(model, opt))
        for b in batches[3:]:                    # in place, while it writes
            step(b)
        mgr.wait()
        ref.save(3, clone)
        assert int(opt.count) == 6
        return ((tmp_path / "async" / "ckpt-3.bin").read_bytes(),
                (tmp_path / "ref" / "ckpt-3.bin").read_bytes())

    got, want = _within(120, body)
    assert got == want


def test_save_async_between_two_graph_replays(dev, tmp_path):
    """``FusedTrainer(k=3)``: a ``save_async`` after the first replay,
    while the next replays update the state in place, holds the state of
    step 3 byte for byte."""
    from dmlc_core_tpu_torch import (DeviceLoader, FactorizationMachine,
                                     FusedTrainer, adam, create_parser)
    from dmlc_core_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      snapshot)
    path = _kstep_file(tmp_path / "k.libsvm", 16 * 7)

    def body():
        model = FactorizationMachine(F, 32, device=dev,
                                     generator=torch.Generator(dev)
                                     .manual_seed(2))
        opt = adam(model, 1e-2)
        mgr = CheckpointManager(str(tmp_path / "async"))
        ref = CheckpointManager(str(tmp_path / "ref"))
        clone = None
        with DeviceLoader(create_parser(path, engine="native"), 16, 1024,
                          device=dev, emit="host") as ld:
            tr = FusedTrainer(model, opt, ld, k=3)
            for item in ld:
                tr.feed(item)
                if tr.steps == 3 and clone is None:
                    clone = snapshot(_fm_state(model, opt))
                    mgr.save_async(3, _fm_state(model, opt))
            tr.flush()
        mgr.wait()
        ref.save(3, clone)
        assert tr.steps == 7
        return ((tmp_path / "async" / "ckpt-3.bin").read_bytes(),
                (tmp_path / "ref" / "ckpt-3.bin").read_bytes())

    got, want = _within(180, body)
    assert got == want


# ---------------------------------------------------------------------------
# the v3 compact wire's decode kernel (kernels/wire_decode.cu)
# ---------------------------------------------------------------------------

def _pack_bits(values, width, nwords):
    bits = ((values.astype(np.uint64)[:, None]
             >> np.arange(width, dtype=np.uint64)) & 1).astype(np.uint8)
    flat = np.zeros(nwords * 32, np.uint8)
    flat[:bits.size] = bits.reshape(-1)
    return np.packbits(flat, bitorder="little").view("<u4").view(np.int32)


def _row_ptr(rng, layout, rows, n_real):
    """row_ptr of ``rows`` rows over ``n_real`` entries: ``random``
    sorted cuts, ``skewed`` (one row holds 90 % of the entries),
    ``empty_rows`` (half of the rows empty), ``zipf`` row lengths,
    ``one_row`` (every entry in the middle row), ``rp0`` (row_ptr[0] > 0:
    the entries before row_ptr[1] are row 0's all the same), or
    ``all_padding`` (no real entry)."""
    if layout == "random":
        rp = np.sort(rng.integers(0, n_real + 1, rows + 1))
        rp[0], rp[-1] = 0, n_real
    elif layout == "skewed":
        c = np.full(rows, (n_real // 10) // rows)
        c[rows // 2] += n_real - c.sum()
        rp = np.concatenate([[0], np.cumsum(c)])
    elif layout == "empty_rows":
        c = rng.integers(1, max(2, 4 * n_real // max(rows, 1)), rows)
        c[rng.permutation(rows)[:rows // 2]] = 0
        rp = np.minimum(np.concatenate([[0], np.cumsum(c)]), n_real)
    elif layout == "zipf":
        rp = np.minimum(np.concatenate([[0], np.cumsum(rng.zipf(1.3, rows))]),
                        n_real)
    elif layout == "one_row":
        rp = np.where(np.arange(rows + 1) > rows // 2, n_real, 0)
    elif layout == "rp0":
        rp = np.sort(rng.integers(0, n_real + 1, rows + 1))
        rp[-1] = n_real
        rp[0] = max(1, rp[1] // 2)
    else:                                     # all_padding
        rp = np.zeros(rows + 1, np.int64)
    return rp.astype(np.int32)


def _v3_buffer(rng, rows, nnz, w, dbits, layout="random"):
    """A v3 buffer built in numpy (ids of w bits; a 2^dbits dictionary,
    or raw values where dbits is 0; row_ptr as ``layout`` says), and its
    meta."""
    from dmlc_core_tpu_torch.kernels.wire_decode import v3_layout
    n_real = int(rng.integers(nnz // 2, nnz + 1))
    rp = _row_ptr(rng, layout, rows, n_real)
    n_real = int(rp[-1])
    ids = rng.integers(0, 1 << w, nnz, dtype=np.int64)
    ids[n_real:] = 0
    code_off, dict_off, _, _ = v3_layout(rows, nnz, w, dbits)
    parts = [_pack_bits(ids, w, (nnz * w + 31) // 32)]
    if dbits:
        table = rng.standard_normal(1 << dbits).astype(np.float32)
        table[0] = 0.0
        codes = rng.integers(0, 1 << dbits, nnz)
        codes[n_real:] = 0
        parts += [_pack_bits(codes, dbits, dict_off - code_off),
                  table.view(np.int32)]
    else:
        vals = rng.standard_normal(nnz).astype(np.float32)
        vals[n_real:] = 0.0
        parts.append(vals.view(np.int32))
    parts += [rp, rng.random(2 * rows).astype(np.float32).view(np.int32)]
    return (np.concatenate(parts).astype(np.int32),
            nnz | (w << 32) | (dbits << 40))


WIRE_CASES = [(8, 0), (12, 2), (20, 4), (20, 0), (24, 16), (28, 8),
              (32, 0), (32, 6)]
WIRE_LAYOUTS = ["random", "skewed", "empty_rows", "zipf", "one_row", "rp0",
                "all_padding"]


@pytest.mark.parametrize("layout", WIRE_LAYOUTS)
@pytest.mark.parametrize("rows,nnz", [(4096, 131072), (64, 1000),
                                      (13000, 40000), (1, 777)])
@pytest.mark.parametrize("w,dbits", WIRE_CASES)
def test_wire_decode_kernel_is_bit_exact(dev, w, dbits, rows, nnz, layout):
    """The kernel's ids, vals and segments equal the plain v3 decode's on
    the card, array for array (bit patterns of vals too), for every row
    layout: a batch whose rows are found by one search round (4096 rows),
    by none (64 rows, a single row) and by two (13,000 rows); a row that
    holds most of the batch, half the rows empty, Zipf row lengths, every
    entry in one row, row_ptr[0] > 0, and a batch that is all padding;
    B not a multiple of the 4 entries a thread stores at once (1000,
    777)."""
    from dmlc_core_tpu_torch.kernels import (wire_decode,
                                             wire_decode_reference)
    rng = np.random.default_rng(w * 100 + dbits + rows
                                + WIRE_LAYOUTS.index(layout))
    host, meta = _v3_buffer(rng, rows, nnz, w, dbits, layout)
    buf = torch.from_numpy(host).to(dev)
    got = wire_decode(buf, rows, nnz, w, dbits)
    want = wire_decode_reference(buf, rows, nnz, w, dbits)
    torch.cuda.synchronize()
    for name, g, r in zip(("ids", "vals", "segments"), got, want):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if name == "vals":
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), name


def test_wire_decode_counts_launches_and_refuses_the_cpu(dev):
    from dmlc_core_tpu_torch.kernels import wire_decode
    from dmlc_core_tpu_torch.utils.logging import DMLCError
    rng = np.random.default_rng(1)
    host, _ = _v3_buffer(rng, 64, 1000, 20, 4)
    n0 = launch_counts().get("wire_decode", 0)
    wire_decode(torch.from_numpy(host).to(dev), 64, 1000, 20, 4)
    assert launch_counts().get("wire_decode", 0) == n0 + 1
    with pytest.raises(DMLCError, match="needs CUDA tensors"):
        wire_decode(torch.from_numpy(host), 64, 1000, 20, 4,
                    engine="kernel")


@pytest.mark.parametrize("w,dbits", [(20, 4), (24, 0)])
def test_wire_decode_records_into_a_cuda_graph(dev, w, dbits):
    """Captured and replayed over new buffers, the decode gives what the
    plain version gives on each."""
    from dmlc_core_tpu_torch.pipeline.loader import make_decoder
    rng = np.random.default_rng(7)
    rows, nnz = 4096, 131072
    bufs = [_v3_buffer(rng, rows, nnz, w, dbits) for _ in range(3)]
    meta = bufs[0][1]
    decode = make_decoder(rows, meta)
    static = torch.from_numpy(bufs[0][0]).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode(static)                       # build and load first
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode(static)
    plain = make_decoder(rows, meta, engine="torch")
    for host, m in bufs:
        assert m == meta
        static.copy_(torch.from_numpy(host).to(dev))
        graph.replay()
        want = plain(static.clone())
        torch.cuda.synchronize()
        for k in ("ids", "segments", "row_ptr", "labels", "weights"):
            assert torch.equal(out[k], want[k]), k
        assert torch.equal(out["vals"].view(torch.int32),
                           want["vals"].view(torch.int32))


def test_compact_loader_on_the_card_equals_v2(dev, tmp_path):
    """The loader's default on the card is the v3 wire, decoded by the
    kernel: every batch equals the v2 wire's, and the kernel ran once a
    batch."""
    path = _feed_file(tmp_path / "d.libsvm", seed=9)
    n0 = launch_counts().get("wire_decode", 0)
    v3, _ = _feed(path, "cuda", {})
    launched = launch_counts().get("wire_decode", 0) - n0
    v2, _ = _feed(path, "cuda", dict(wire_compact=False))
    torch.cuda.synchronize()
    assert len(v3) == len(v2) == 18 and launched == 18
    for a, b in zip(v3, v2):
        for k in b:
            assert torch.equal(a[k], b[k]), k


def test_profile_trace_names_the_ragged_gather_kernel(dev, tmp_path):
    """``profile_trace`` around one ragged forward on the card: the
    written Chrome trace holds the kernel (``ragged_gather_kernel``, the
    ``__global__`` symbol of ragged_gather.cu) as a device event, inside
    the window of the ``trace_span`` range around the call."""
    import json

    from dmlc_core_tpu_torch.utils.metrics import profile_trace, trace_span
    rng = np.random.default_rng(17)
    rows, cap = 64, 2048
    ids = torch.from_numpy(rng.integers(0, F, cap).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.random(cap, np.float32)).to(dev)
    segs = torch.from_numpy(np.sort(rng.integers(0, rows, cap)).astype(
        np.int32)).to(dev)
    tab = torch.from_numpy(rng.random((F, 32), np.float32)).to(dev)
    ragged_gather(ids, vals, segs, cap, tab, rows, fm=True)   # builds it
    torch.cuda.synchronize()
    with profile_trace(str(tmp_path)) as prof:
        with trace_span("test.forward"):
            ragged_gather(ids, vals, segs, cap, tab, rows, fm=True)
        torch.cuda.synchronize()
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "ragged_gather_kernel" in e.get("name", "")]
    assert len(kernels) == 1, sorted({e.get("name") for e in events})
    assert any(e.get("name") == "test.forward" for e in events)


# -- data parallelism over a world-1 NCCL mesh -------------------------------

def _flat_batches(dev, n, rows=16, cap=128, seed=4):
    from dmlc_core_tpu_torch.data import RowBlock, parse_libsvm
    from dmlc_core_tpu_torch.pipeline import pack_flat
    rng = np.random.default_rng(seed)
    lines = b"\n".join(b"%d " % (i & 1) + b" ".join(
        b"%d:%.3f" % (j, rng.random()) for j in
        np.sort(rng.choice(F, 6, replace=False)).tolist())
        for i in range(rows * n)) + b"\n"
    d = parse_libsvm(lines)
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                   d["weights"])
    return [{k: torch.from_numpy(v).to(dev) for k, v in
             pack_flat(blk.slice(lo, lo + rows), rows, cap).items()}
            for lo in range(0, rows * n, rows)]


@pytest.fixture
def nccl_mesh(dev):
    import torch.distributed as dist

    from dmlc_core_tpu_torch.parallel import make_mesh
    if dist.is_initialized():
        pytest.skip("this process already has a process group")
    mesh = make_mesh("dp=-1")
    yield mesh
    mesh.close()


def _fm(dev, engine):
    from dmlc_core_tpu_torch import FactorizationMachine
    return FactorizationMachine(F, 8, l2=1e-3, engine=engine, device=dev,
                                generator=torch.Generator(dev).manual_seed(1))


def _params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def test_nccl_world1_steps_are_the_no_mesh_steps(dev, nccl_mesh):
    """At world 1 the dp step adds nothing: on the plain path with
    deterministic algorithms its parameters and losses are array_equal
    to the no-mesh step's (the kernels' atomics vary from run to run)."""
    from dmlc_core_tpu_torch.models import make_train_step
    batches = _flat_batches(dev, 4)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for mesh in (nccl_mesh, None):
            m = _fm(dev, "torch")
            step = make_train_step(m, adam(m, 1e-2, engine="torch"), mesh)
            runs.append((torch.stack([step(b) for b in batches]),
                         _params(m)))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_nccl_world1_kbatch_captures_the_all_reduces(dev, nccl_mesh):
    """Over NCCL the k-step mesh form is one captured graph (its two
    all-reduces a step inside it) and follows the per-step mesh steps."""
    from dmlc_core_tpu_torch.models import (make_train_step,
                                            make_train_step_kbatch,
                                            stack_batches)
    batches = _flat_batches(dev, 4)
    a, b = _fm(dev, "kernel"), _fm(dev, "kernel")
    kstep = make_train_step_kbatch(a, adam(a, 1e-2), nccl_mesh)
    assert kstep.route == "graph"
    before = _counts().get("ragged_gather_fm", 0)
    got = torch.cat([kstep(stack_batches(batches[:2])),
                     kstep(stack_batches(batches[2:]))])
    assert _counts().get("ragged_gather_fm", 0) - before == 5  # 4 + warm-up
    step = make_train_step(b, adam(b, 1e-2), nccl_mesh)
    want = torch.stack([step(x) for x in batches])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(_params(a), _params(b), rtol=1e-5, atol=1e-6)


def test_nccl_collectives_on_card_tensors(dev, nccl_mesh):
    from dmlc_core_tpu_torch.parallel import (MeshCollectives, allgather,
                                              reduce_scatter)
    coll = MeshCollectives(nccl_mesh)
    x = torch.arange(12, dtype=torch.float32, device=dev).view(1, 12)
    for op in ("sum", "max", "min"):
        assert torch.equal(coll.allreduce(x, op), x)
    assert torch.equal(coll.broadcast(x), x)
    assert torch.equal(coll.allgather(x), x.view(1, 1, 12))
    assert torch.equal(allgather(x, nccl_mesh), x)
    assert torch.equal(reduce_scatter(x, nccl_mesh), x)
    assert torch.equal(coll.all_to_all(x), x)


# -- elastic rejoin on the card (ROADMAP A.7.c1) ------------------------------

def test_snapshot_tree_copies_card_tensors_to_the_host(dev):
    from dmlc_core_tpu_torch.parallel import snapshot_tree
    t = {"v": torch.arange(12, dtype=torch.float32, device=dev).view(4, 3),
         "n": torch.tensor(5, dtype=torch.int32, device=dev)}
    snap = snapshot_tree(t)
    (_, _, v), = snap.pieces["v"]
    (_, _, n), = snap.pieces["n"]
    t["v"].add_(1)
    assert isinstance(v, np.ndarray)
    np.testing.assert_array_equal(v, np.arange(12, dtype=np.float32)
                                  .reshape(4, 3))
    assert snap.schema == {"v": ((4, 3), "float32"), "n": ((), "int32")}
    assert n.tolist() == [5]


NCCL_ELASTIC_WORKER = r'''
import faulthandler, json, os, sys
faulthandler.dump_traceback_later(150, exit=True)   # a hang shows its stacks
import numpy as np
import torch
from dmlc_core_tpu_torch import FactorizationMachine, adam
from dmlc_core_tpu_torch.models import make_train_step_kbatch
from dmlc_core_tpu_torch.parallel import (ElasticTorchMesh, RabitContext,
                                          StateHandle, allgather, allreduce)
from dmlc_core_tpu_torch.utils.logging import DMLCError

attempt = int(os.environ["DMLC_NUM_ATTEMPT"])
victim = int(os.environ["VICTIM"])
ctx = RabitContext.from_env(heartbeat_interval=0)
if attempt:
    assert ctx.load_checkpoint() == {"phase": 1}
dev = torch.device("cuda", ctx.rank)
state = {"w": np.arange(8, dtype=np.float32)}
box = {"state": None if attempt else state}
mesh = ElasticTorchMesh(ctx, device=dev)
mesh.register_state(StateHandle(lambda: box["state"], template=state))
out = {"rank": ctx.rank}
if attempt == 0:
    mesh.initialize()
    g0 = mesh.mesh
    assert g0.backend == "nccl" and g0.capturable
    # a k-step graph captured over generation 0's communicators
    model = FactorizationMachine(64, 4, device=dev)
    kstep = make_train_step_kbatch(model, adam(model, 1e-2), g0)
    assert kstep.route == "graph"
    i32 = dict(dtype=torch.int32, device=dev)
    batch = {"ids": torch.tensor([[1, 3, 5, 0]], **i32),
             "vals": torch.ones(1, 4, device=dev),
             "segments": torch.tensor([[0, 0, 1, 2]], **i32),
             "row_ptr": torch.tensor([[0, 2, 3]], **i32),
             "labels": torch.tensor([[0.0, 1.0]], device=dev),
             "weights": torch.ones(1, 2, device=dev)}
    kstep(batch)
    x = allreduce(torch.ones(4, device=dev), g0)
    assert x.tolist() == [float(ctx.world_size)] * 4
    torch.cuda.synchronize()
    ctx.checkpoint({"phase": 1})
    if ctx.rank == victim:
        os._exit(7)
    res = mesh.resync()
    assert res
    for name, call in (("allreduce", lambda: allreduce(x, g0)),
                       ("kstep", lambda: kstep(batch))):
        try:
            call()
            out[name] = "ran"
        except DMLCError as e:
            out[name] = str(e)
else:
    res = mesh.resync()
g1 = mesh.mesh
assert mesh.generation == 1 and g1.generation == 1 and g1.backend == "nccl"
y = torch.full((5,), float(ctx.rank + 1), device=dev)
out["sum"] = allreduce(y, g1).tolist()
out["gather"] = allgather(y[:1], g1).tolist()
out["restored"] = np.array_equal(res.state["w"], state["w"])
out["timings"] = mesh.timings
mesh.close()
ctx.shutdown()
print("RESULT " + json.dumps(out), flush=True)
'''


def test_nccl_rebuild_after_a_rank_is_killed(dev, tmp_path):
    """A card a rank, NCCL: the last rank exits 7 after a collective and
    a captured k-step call of generation 0, is respawned with attempt 1,
    and every rank rebuilds at generation 1 (the survivors' generation 0
    communicators, which hold the dead rank, aborted within the
    teardown's bound), where an all-reduce and an all-gather over the
    new communicators are exact; the old generation's collective and
    its captured graph raise instead of running; the reborn rank gets
    the state from peers."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from dmlc_core_tpu_torch.parallel import tracker
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two or more cards")
    script = tmp_path / "worker.py"
    script.write_text(NCCL_ELASTIC_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    base = s.getsockname()[1]
    s.close()
    t = tracker.RabitTracker(num_workers=world, host_ip="127.0.0.1")
    t.start()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, **t.worker_envs(), "PYTHONPATH": repo,
           "DMLC_ELASTIC_BASE_PORT": str(base), "VICTIM": str(world - 1),
           "DMLC_CHECKPOINT_DIR": str(tmp_path)}

    def spawn(rank, attempt):
        log = open(tmp_path / f"r{rank}_a{attempt}.log", "w+")
        return subprocess.Popen(
            [sys.executable, str(script)], env=dict(
                env, DMLC_TASK_ID=str(rank), DMLC_NUM_ATTEMPT=str(attempt)),
            stdout=log, stderr=subprocess.STDOUT, text=True), log

    procs = {r: spawn(r, 0) for r in range(world)}
    try:
        assert procs[world - 1][0].wait(timeout=180) == 7
        procs[world - 1] = spawn(world - 1, 1)
        for p, _ in procs.values():
            p.wait(timeout=200)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        t.stop()
    texts = {}
    for r, (p, log) in procs.items():
        log.seek(0)
        texts[r] = log.read()
        log.close()
    bad = {r: p.returncode for r, (p, _) in procs.items() if p.returncode}
    assert not bad, (bad, {r: texts[r][-2500:] for r in texts})
    outs = {r: json.loads(next(ln for ln in texts[r].splitlines()
                               if ln.startswith("RESULT "))[7:])
            for r in texts}
    total = world * (world + 1) / 2
    for r, o in outs.items():
        assert o["sum"] == [total] * 5
        assert o["gather"] == [float(i + 1) for i in range(world)]
        assert o["restored"]
        if r < world - 1:
            assert "mesh generation 0 is closed" in o["allreduce"]
            assert "mesh generation 0 is closed" in o["kstep"]
            assert o["timings"]["teardown_s"] < 10


# -- the sharded embedding table (ROADMAP A.8) --------------------------------

def _embed_batch(rng, n, rows, nnz, cap):
    """A ragged batch dict with garbage tails and a hot id (many entries
    land on one unique row, as dedup_ids makes them)."""
    ids = rng.integers(0, n, cap).astype(np.int32)
    ids[:nnz // 4] = 7                                   # the hot id
    ids[nnz:] = rng.integers(-9, 10 ** 6, cap - nnz)     # garbage tail
    vals = rng.standard_normal(cap).astype(np.float32)
    segs = np.full(cap, rows + 3, np.int32)
    segs[:nnz] = np.sort(rng.integers(0, rows - 2, nnz))
    return {"ids": ids, "vals": vals, "segments": segs,
            "row_ptr": np.zeros(rows + 1, np.int32),
            "labels": np.zeros(rows, np.float32),
            "weights": np.ones(rows, np.float32),
            "nnz_used": np.int32(nnz), "rows_used": np.int32(rows - 2)}


@pytest.mark.parametrize("D", [1, 8, 32])
@pytest.mark.parametrize("n,rows,nnz,cap", [(4096, 64, 1500, 2048),
                                            (1 << 16, 512, 20000, 24576)])
def test_embed_table_lookup_and_backward_match_plain(dev, D, n, rows, nnz,
                                                     cap):
    """The table's pooled gather and row gradients through the ragged
    kernels (``engine="auto"`` on the card) against the plain version on
    the same card, the same unique-row matrix and the same batch.  The
    hot id's row sums thousands of entries in an order the atomics set:
    its gradient is held within rtol = atol = 1e-5 of its terms' sizes
    (``_sums_close``'s rule), from a plain backward over ``|vals|`` and
    ``|g|``."""
    from dmlc_core_tpu_torch.embed import ShardedEmbeddingTable
    from dmlc_core_tpu_torch.kernels import reset_launch_counts
    batch = _embed_batch(np.random.default_rng(D + n), n, rows, nnz, cap)
    kern = ShardedEmbeddingTable(n, D, seed=3, device=dev)
    plain = ShardedEmbeddingTable(n, D, seed=3, device=dev, engine="torch")
    reset_launch_counts()
    got = kern.lookup(batch)
    want = plain.lookup(batch)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[rows - 2:] == 0).all()
    g = np.random.default_rng(1).standard_normal((rows, D)).astype(
        np.float32)
    assert kern.backward(batch, torch.from_numpy(g).to(dev)) == \
        plain.backward(batch, g)
    assert sorted(kern._pending) == sorted(plain._pending)
    sizes = ShardedEmbeddingTable(n, D, seed=3, device=dev, engine="torch")
    sizes.backward(dict(batch, vals=np.abs(batch["vals"])), np.abs(g))
    for k, v in plain._pending.items():
        err = np.abs(kern._pending[k] - v)
        assert (err <= TOL["atol"] + TOL["rtol"] * sizes._pending[k]).all(), k
    counts = launch_counts()
    assert counts.get("ragged_gather_embed", 0) == 1
    assert counts.get("ragged_gather_grad_embed", 0) == 1
    # the plain table launched nothing: one of each, the kernel table's
    assert plain.lookup(batch, engine="torch").shape == (rows, D)
    assert launch_counts() == counts


def test_embed_kill_and_no_kill_agree_on_the_card(dev, tmp_path):
    """Three gloo ranks on this card run the port's example with a kill
    and without one.  The ragged backward adds a hot row's entries with
    atomics, so the two runs agree to rounding only: losses within
    rtol 1e-5 (atol 1e-6).  Within each run every interval's holders,
    primary and replica, hold the same bits after every flush, and each
    rank launched both ragged kernels."""
    from test_torch_embed_train import (WORLD, _holders_agree, _libsvm,
                                        _report_lines, run_cohort)
    uri = _libsvm(tmp_path)
    extra = ("--device", "cuda")
    nk, nk_dir = run_cohort(uri, tmp_path, "nk", kill=False, extra=extra)
    kk, kk_dir = run_cohort(uri, tmp_path, "k", kill=True, extra=extra)
    a = {(r["rank"], r["epoch"]): r for r in nk}
    b = {(r["rank"], r["epoch"]): r for r in kk}
    assert sorted(a) == sorted(b) == [(r, e) for r in range(WORLD)
                                      for e in range(3)]
    for key in a:
        np.testing.assert_allclose(b[key]["loss"], a[key]["loss"],
                                   rtol=1e-5, atol=1e-6, err_msg=str(key))
    assert b[(2, 1)]["rebuilt"] and b[(2, 1)]["from_peers"] >= 1
    assert all(r["from_ckpt"] == 0 for r in kk)
    for rdir in (nk_dir, kk_dir):
        lines = _report_lines(rdir)
        for ivs in _holders_agree(lines).values():
            assert all(n == 1 for n in ivs.values()), ivs
        last = {}
        for ln in lines:
            last[ln["rank"]] = ln["launches"]
        for r, launches in last.items():
            assert launches.get("ragged_gather_embed", 0) > 0, r
            assert launches.get("ragged_gather_grad_embed", 0) > 0, r
