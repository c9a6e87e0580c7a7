"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card.  CUDA kernels have no CPU mode, so every test here is marked
``cuda`` and skips on a host without a card; this file imports no JAX so
that it runs on a card machine that has none.

Tolerance ``rtol = atol = 1e-5``: the ragged gather and the backward
kernels add with atomics in no fixed order, fm_terms and the embed-bag
forward sum in a fixed order (so both are also held bit-equal from call
to call) but not the plain version's.  The autograd
``Function``s are checked with ``torch.autograd.gradcheck`` in float64 on
their plain path (the kernels take float32 only).
"""

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
