"""The port's control-plane endpoint lists
(``dmlc_core_tpu_torch/transport/endpoints.py``) held against the JAX
package's on the CPU.

* ``parse_endpoints`` gives the JAX lists on the same specs, and refuses
  the same malformed ones.
* ``EndpointSet``: the JAX tests of sticky failover and of the
  ``control_epoch`` fence (``tests/test_control_ha.py``), run on both
  packages' classes with the same scripted endpoints, which must see the
  same calls in the same order and give the same answers; a breaker that
  opened skips its endpoint, and a walk where every endpoint fails
  raises naming each.
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dmlc_core_tpu.transport import endpoints as jendpoints  # noqa: E402
from dmlc_core_tpu.utils import logging as jlogging  # noqa: E402
from dmlc_core_tpu.utils.metrics import metrics as jmetrics  # noqa: E402
from dmlc_core_tpu_torch.transport import endpoints  # noqa: E402
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402

PACKAGES = {"port": (endpoints, DMLCError, metrics),
            "jax": (jendpoints, jlogging.DMLCError, jmetrics)}

SPECS = [
    ("h", 1),
    ("h", "80"),
    ["h", 2],
    "a:1",
    "a:1,b:2, a:1",
    " a:1 ,, b:2 ,",
    [("a", 1), "b:2,c:3"],
    ["x:1", ["y:2", ("z", "3"), "w:4"], ("x", 1)],
    "::1:9000",
    "[::1]:9000,127.0.0.1:7",
    ("10.0.0.1", 65535),
]
BAD = ["", " , ", "noport", "a:1,noport", [], "a:x"]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_parse_endpoints_matches_jax(spec):
    assert endpoints.parse_endpoints(spec) == \
        jendpoints.parse_endpoints(spec)


@pytest.mark.parametrize("spec", BAD, ids=repr)
def test_parse_endpoints_refuses_what_jax_refuses(spec):
    errors = []
    for mod, err, _ in PACKAGES.values():
        with pytest.raises((err, ValueError)) as info:
            mod.parse_endpoints(spec)
        errors.append(type(info.value).__name__)
    assert errors[0] == errors[1]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_parse_endpoints_grammar(pkg):
    """The JAX grammar test (``tests/test_control_ha.py``)."""
    mod, err, _ = PACKAGES[pkg]
    assert mod.parse_endpoints(("h", 1)) == [("h", 1)]
    assert mod.parse_endpoints("a:1,b:2, a:1") == [("a", 1), ("b", 2)]
    assert mod.parse_endpoints([("a", 1), "b:2,c:3"]) == \
        [("a", 1), ("b", 2), ("c", 3)]
    # IPv6: the LAST colon separates host from port
    assert mod.parse_endpoints("::1:9000") == [("::1", 9000)]
    with pytest.raises(err):
        mod.parse_endpoints("")
    with pytest.raises(err):
        mod.parse_endpoints("noport")


def _scripted(calls, replies):
    def fn(addr):
        calls.append(addr)
        out = replies[addr]
        if isinstance(out, Exception):
            raise out
        return out
    return fn


def _failover_story(pkg):
    """The JAX failover and fencing test's steps; returns what each step
    saw, for the cross-package comparison."""
    mod, _, _ = PACKAGES[pkg]
    es = mod.EndpointSet("a:1,b:2", name="t")
    calls, seen = [], []
    # the primary answers: sticky
    out = es.call(_scripted(calls, {("a", 1): {"ok": 1, "control_epoch": 3},
                                    ("b", 2): {"ok": 2}}))
    assert out == {"ok": 1, "control_epoch": 3}
    assert es.control_epoch() == 3
    seen.append((out, es.current(), es.control_epoch()))
    # the primary is dead: the walk reaches b, which becomes current
    out = es.call(_scripted(calls, {("a", 1): OSError("down"),
                                    ("b", 2): {"ok": 2, "control_epoch": 4}}))
    assert out == {"ok": 2, "control_epoch": 4}
    assert es.current() == ("b", 2)
    seen.append((out, es.current(), es.control_epoch()))
    # a reply stamped BELOW the highest epoch seen is a fenced primary:
    # refused, and the call lands on the other endpoint
    out = es.call(_scripted(calls, {("b", 2): {"ok": "stale",
                                               "control_epoch": 3},
                                    ("a", 1): {"ok": "fresh",
                                               "control_epoch": 4}}))
    assert out["ok"] == "fresh"
    seen.append((out, es.current(), es.control_epoch()))
    # replies without an epoch (or not a dict) are never fenced
    out = es.call(_scripted(calls, {("a", 1): [1, 2], ("b", 2): None}))
    assert out == [1, 2]
    seen.append((out, es.current(), es.control_epoch()))
    return calls, seen


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_endpointset_failover_and_stale_epoch_rejection(pkg):
    _failover_story(pkg)


def test_endpointset_walks_as_jax_does():
    assert _failover_story("port") == _failover_story("jax")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_open_breaker_skips_its_endpoint_and_all_failed_raises(
        pkg, monkeypatch):
    """With a threshold of one failure, a dead endpoint's breaker opens
    at its first failure and later walks skip it (no call reaches it);
    when every endpoint fails the call raises, naming each one.  The
    failover counter counts each change of the current endpoint."""
    mod, err, reg = PACKAGES[pkg]
    monkeypatch.setenv("DMLC_T_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("DMLC_T_BREAKER_COOLDOWN", "60")
    es = mod.EndpointSet([("a", 1), ("b", 2), ("c", 3)], env_prefix="DMLC_T",
                         name="walk")
    failovers = reg.counter("transport.endpoints.failovers").value
    calls = []
    replies = {("a", 1): OSError("refused"), ("b", 2): {"ok": "b"},
               ("c", 3): {"ok": "c"}}
    assert es.call(_scripted(calls, replies)) == {"ok": "b"}
    assert es.call(_scripted(calls, replies)) == {"ok": "b"}
    assert calls == [("a", 1), ("b", 2), ("b", 2)]
    replies[("b", 2)] = err("broken reply")
    assert es.call(_scripted(calls, replies)) == {"ok": "c"}
    assert es.current() == ("c", 3)
    replies[("c", 3)] = OSError("gone")
    with pytest.raises(err, match="all 3 endpoint") as info:
        es.call(_scripted(calls, replies))
    for name in ("a:1", "b:2", "c:3"):
        assert name in str(info.value)
    # the open breakers of a and b kept the last walks off them
    assert calls == [("a", 1), ("b", 2), ("b", 2), ("b", 2), ("c", 3),
                     ("c", 3)]
    assert reg.counter("transport.endpoints.failovers").value \
        - failovers == 2
    assert len(es) == 3 and es.primary == ("a", 1)
