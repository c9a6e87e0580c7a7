"""The port's transfer planner (``transport/plan.py``) held against the
JAX package's: ``plan_rounds`` gives the same rounds, transfer for
transfer and in order, over seeded random transfer sets (numpy seeds),
with the byte bound off (``max_bytes=None``), tight and loose, the slot
cap off (``per_holder <= 0``) and on, and with transfers larger than the
budget.  Exact equality: the planner is a pure function."""

import numpy as np
import pytest

pytest.importorskip("jax")

from dmlc_core_tpu.transport import plan as jplan  # noqa: E402
from dmlc_core_tpu_torch.transport import plan as tplan  # noqa: E402

SEEDS = range(12)
OPTIONS = [dict(max_bytes=None, per_holder=2),
           dict(max_bytes=None, per_holder=0),
           dict(max_bytes=4096, per_holder=2),
           dict(max_bytes=4096, per_holder=-1),
           dict(max_bytes=1 << 20, per_holder=1),
           dict(max_bytes=100, per_holder=3)]


def _transfers(mod, seed):
    """Seeded transfers: a few leaves, holders 0-4, sizes from 1 byte to
    past the tighter budgets, ties in size and path on purpose."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    out = []
    for i in range(n):
        start = int(rng.integers(0, 1000))
        stop = start + int(rng.integers(1, 200))
        owner = int(rng.integers(0, 5))
        alts = sorted({int(a) for a in rng.integers(0, 5, size=2)}
                      - {owner})
        nbytes = int(rng.choice([1, 64, 4096, 5000, 1 << 16, 1 << 21]))
        out.append(mod.Transfer(f"leaf{int(rng.integers(0, 4))}", start,
                                stop, owner, alts, nbytes=nbytes, tag=i))
    return out


def _key(rounds):
    return [[(t.path, t.start, t.stop, t.owner, t.alts, t.nbytes, t.tag)
             for t in rnd] for rnd in rounds]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("opts", OPTIONS,
                         ids=lambda o: f"{o['max_bytes']}-{o['per_holder']}")
def test_plan_rounds_equals_the_jax_planner(seed, opts):
    got = tplan.plan_rounds(_transfers(tplan, seed), **opts)
    want = jplan.plan_rounds(_transfers(jplan, seed), **opts)
    assert _key(got) == _key(want)
    # every transfer placed once
    assert sorted(t.tag for rnd in got for t in rnd) == \
        sorted(t.tag for t in _transfers(tplan, seed))


def test_oversized_transfer_gets_a_round_of_its_own():
    big = [tplan.Transfer("a", 0, 10, 0, nbytes=10_000, tag="big"),
           tplan.Transfer("b", 0, 1, 1, nbytes=10, tag="small")]
    got = tplan.plan_rounds(big, max_bytes=100)
    want = jplan.plan_rounds(
        [jplan.Transfer("a", 0, 10, 0, nbytes=10_000, tag="big"),
         jplan.Transfer("b", 0, 1, 1, nbytes=10, tag="small")],
        max_bytes=100)
    assert _key(got) == _key(want) == [[("a", 0, 10, 0, (), 10_000, "big")],
                                       [("b", 0, 1, 1, (), 10, "small")]]


def test_repr_and_empty_set():
    t = tplan.Transfer("p", 1, 3, 2, nbytes=8)
    assert repr(t) == repr(jplan.Transfer("p", 1, 3, 2, nbytes=8))
    assert tplan.plan_rounds([]) == jplan.plan_rounds([]) == []
