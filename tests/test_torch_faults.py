"""The port's fault injection (``utils/faults.py``), held against the JAX
package's on the CPU.

* The spec grammar: a malformed spec raises ``FaultSpecError`` in both
  packages, at parse time.
* Sites by exact name and by prefix glob; ``times``, ``after``, ``lp``
  and ``latency``; the ``faults.<site>.errors`` / ``.delays`` counters.
* ``DMLC_FAULT_SPEC`` is re-read at the next probe; an explicit plan
  wins over it; with neither, a probe is a no-op that counts nothing.
* The same spec and seed give the same fire and no-fire sequence over
  1,000 calls in both packages.
"""

import time

import pytest

pytest.importorskip("jax")

from dmlc_core_tpu.utils import faults as jfaults  # noqa: E402
from dmlc_core_tpu_torch.utils import faults  # noqa: E402
from dmlc_core_tpu_torch.utils.metrics import metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _no_leaked_plan(monkeypatch):
    monkeypatch.delenv("DMLC_FAULT_SPEC", raising=False)
    faults.clear_faults()
    jfaults.clear_faults()
    yield
    faults.clear_faults()
    jfaults.clear_faults()


def _count(name):
    return metrics.counter(name).value


def _fires(mod, site, n):
    """Which of ``n`` probes of ``site`` raised, as a string of 0/1."""
    out = []
    for _ in range(n):
        try:
            mod.fault_point(site)
            out.append("0")
        except mod.FaultInjected:
            out.append("1")
    return "".join(out)


@pytest.mark.parametrize("spec", [
    "", ",", ":error=1", "x:error", "x:error=abc", "x:latency=soon",
    "x:times=1.5", "x:after=x", "x:seed=", "x:bogus=1", "x:error=1:lp",
])
def test_malformed_specs_raise_in_both_packages(spec):
    with pytest.raises(faults.FaultSpecError):
        faults.install_faults(spec)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.install_faults(spec)
    assert faults.active_spec() is None


def test_injected_error_is_an_oserror_and_counted():
    before = _count("faults.t.site.errors")
    with faults.inject_faults("t.site:error=1"):
        with pytest.raises(OSError, match="injected fault at 't.site'"):
            faults.fault_point("t.site")
        faults.fault_point("t.other")           # another site: untouched
    assert _count("faults.t.site.errors") == before + 1
    assert _count("faults.t.other.errors") == 0
    faults.fault_point("t.site")                 # the plan is gone


def test_prefix_glob_matches_every_site_below_it():
    with faults.inject_faults("t.glob.*:error=1"):
        for site in ("t.glob.a", "t.glob.b.c"):
            with pytest.raises(faults.FaultInjected):
                faults.fault_point(site)
        faults.fault_point("t.globx")
        faults.fault_point("t.other")


def test_times_and_after_shape_the_schedule():
    with faults.inject_faults("t.ta:error=1:after=2:times=3"):
        assert _fires(faults, "t.ta", 8) == "00111000"


def test_latency_and_lp():
    before = _count("faults.t.lat.delays")
    with faults.inject_faults("t.lat:latency=20ms"):
        t0 = time.monotonic()
        for _ in range(3):
            faults.fault_point("t.lat")
        assert time.monotonic() - t0 >= 0.055
    assert _count("faults.t.lat.delays") == before + 3
    # lp=0: the latency never fires; lp=0.5: some fire, by the seed
    with faults.inject_faults("t.lp0:latency=50ms:lp=0"):
        t0 = time.monotonic()
        for _ in range(20):
            faults.fault_point("t.lp0")
        assert time.monotonic() - t0 < 0.5
    assert _count("faults.t.lp0.delays") == 0
    with faults.inject_faults("t.lp:latency=1ms:lp=0.5:seed=3"):
        for _ in range(40):
            faults.fault_point("t.lp")
    assert 0 < _count("faults.t.lp.delays") < 40


@pytest.mark.parametrize("raw,seconds", [("50ms", 0.05), ("0.2s", 0.2),
                                         ("1.5", 1.5), (" 7MS ", 0.007)])
def test_duration_grammar_matches_jax(raw, seconds):
    assert faults._parse_duration(raw) == jfaults._parse_duration(raw) \
        == pytest.approx(seconds)


def test_env_spec_is_read_at_the_next_probe(monkeypatch):
    monkeypatch.setenv("DMLC_FAULT_SPEC", "t.env:error=1")
    assert faults.active_spec() == "t.env:error=1"
    with pytest.raises(faults.FaultInjected):
        faults.fault_point("t.env")
    monkeypatch.setenv("DMLC_FAULT_SPEC", "t.env2:error=1")
    faults.fault_point("t.env")                  # the new spec took over
    with pytest.raises(faults.FaultInjected):
        faults.fault_point("t.env2")
    # an explicit plan wins over the environment until it is cleared
    faults.install_faults("t.mine:error=1")
    faults.fault_point("t.env2")
    assert faults.active_spec() == "t.mine:error=1"
    faults.clear_faults()
    with pytest.raises(faults.FaultInjected):
        faults.fault_point("t.env2")
    monkeypatch.setenv("DMLC_FAULT_SPEC", "")
    faults.fault_point("t.env2")
    assert faults.active_spec() is None


def test_no_plan_is_a_no_op():
    assert faults.active_spec() is None
    for _ in range(1000):
        faults.fault_point("t.noop")
    assert faults._plan is None
    # no counter was even created
    assert not any(k.startswith("faults.t.noop") for k in metrics.snapshot())


@pytest.mark.parametrize("spec", [
    "t.det:error=0.2:seed=7",
    "t.det:error=0.5:seed=123:after=10:times=200",
    "t.det:error=0.05",
    "t.*:error=0.3:seed=9,t.det:error=0.1:seed=4",
])
def test_same_spec_and_seed_give_the_same_schedule_in_both_packages(spec):
    faults.install_faults(spec)
    jfaults.install_faults(spec)
    port = _fires(faults, "t.det", 1000)
    jax_ = _fires(jfaults, "t.det", 1000)
    assert port == jax_
    assert 0 < port.count("1") < 1000
    # and again from scratch: a fixed seed replays the schedule
    faults.install_faults(spec)
    assert _fires(faults, "t.det", 1000) == port
