"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card.  CUDA kernels have no CPU mode, so every test here is marked
``cuda`` and skips on a host without a card; this file imports no JAX so
that it runs on a card machine that has none.

Tolerance ``rtol = atol = 1e-5``: the ragged gather adds with atomics in
no fixed order, fm_terms sums in order but with fused multiply-adds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dmlc_core_tpu_torch.kernels import (fm_terms,  # noqa: E402
                                         fm_terms_reference, launch_counts,
                                         ragged_gather,
                                         ragged_gather_reference)

pytestmark = pytest.mark.cuda

F = 4096
TOL = dict(rtol=1e-5, atol=1e-5)
BAD_IDS = [-1, F, F + 7]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("fm", [False, True])
@pytest.mark.parametrize("D", [1, 8, 32, 33])
def test_ragged_gather_kernel_matches_plain(dev, fm, D):
    rng = np.random.default_rng(D)
    rows, cap, n = 16, 512, 300
    ids = rng.integers(0, F, cap).astype(np.int32)
    ids[:3] = BAD_IDS
    vals = rng.normal(size=cap).astype(np.float32)
    segs = rng.integers(0, rows + 1, cap).astype(np.int32)   # unsorted
    ids[n:], vals[n:] = 2 ** 31 - 1, np.nan                 # garbage tail
    segs[n:] = -3
    table = rng.normal(size=(F, D)).astype(np.float32)
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


@pytest.mark.parametrize("D", [8, 32, 40])
def test_fm_terms_kernel_matches_plain(dev, D):
    rng = np.random.default_rng(12)
    B, K = 16, 8
    ids = rng.integers(0, F, (B, K)).astype(np.int32)
    ids[:, :3] = BAD_IDS
    vals = rng.random((B, K)).astype(np.float32)
    table = rng.random((F, D)).astype(np.float32)
    a = [torch.from_numpy(x).to(dev) for x in (ids, vals, table)]
    for g, w in zip(fm_terms(*a), fm_terms_reference(*a)):
        torch.testing.assert_close(g, w, **TOL)


def test_kernels_refuse_autograd(dev):
    ids = torch.zeros(4, dtype=torch.int32, device=dev)
    table = torch.ones(8, 4, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ragged_gather(ids, torch.ones(4, device=dev), ids, None, table, 2,
                      fm=True)
