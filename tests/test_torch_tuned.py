"""The port's persisted transfer tuning (``pipeline/tuned.py``), held
against the JAX package's on the CPU.

* ``resolve``'s precedence (an explicit value, then ``DMLC_PUT_THREADS``
  / ``DMLC_WIRE_COMPACT``, then the file, then the built-in default) for
  ``cpu`` and ``cuda``, against JAX ``resolve`` for ``cpu`` and ``gpu``
  on the same file and environment;
* the port's ``cuda`` key and the JAX package's ``gpu`` / ``tpu`` keys
  never steer each other;
* concurrent ``save_tuned`` / ``save_autotuned`` writers all land;
* an ``"autotune"`` entry written by one package is loaded by the other,
  and the loader's ``"auto"`` knobs come from ``resolve``.
"""

import json
import threading

import pytest

pytest.importorskip("jax")

from dmlc_core_tpu.pipeline import tuned as jtuned  # noqa: E402
from dmlc_core_tpu_torch.pipeline import tuned  # noqa: E402


@pytest.fixture()
def tuned_file(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(path))
    monkeypatch.delenv("DMLC_PUT_THREADS", raising=False)
    monkeypatch.delenv("DMLC_WIRE_COMPACT", raising=False)
    return path


@pytest.mark.parametrize("ours,theirs", [("cpu", "cpu"), ("cuda", "gpu")])
def test_resolve_precedence_matches_jax(tuned_file, monkeypatch, ours,
                                        theirs):
    def both(pt, wc):
        got = tuned.resolve(ours, pt, wc)
        assert got == jtuned.resolve(theirs, pt, wc)
        return got

    # built-in defaults: the CPU ships v2, any card v3
    assert both("auto", "auto") == (1, ours != "cpu")
    # the persisted file replaces the built-ins (put_threads off the CPU)
    entry = {"put_threads": 4, "wire_compact": ours == "cpu"}
    tuned.save_tuned({"platform": ours, **entry})
    jtuned.save_tuned({"platform": theirs, **entry})
    assert both("auto", "auto") == ((1, False) if ours == "cpu"
                                    else (4, False))
    # the environment beats the file
    monkeypatch.setenv("DMLC_PUT_THREADS", "2")
    monkeypatch.setenv("DMLC_WIRE_COMPACT", "1")
    assert both("auto", "auto") == (2, True)
    # an explicit value beats everything
    assert both(8, False) == (8, False)
    # a malformed environment falls through to the file, without raising
    monkeypatch.setenv("DMLC_PUT_THREADS", "banana")
    monkeypatch.setenv("DMLC_WIRE_COMPACT", "definitely")
    assert both("auto", "auto") == ((1, False) if ours == "cpu"
                                    else (4, False))
    assert tuned.tuned_path() == jtuned.tuned_path() == str(tuned_file)


def test_cuda_and_the_jax_backends_do_not_steer_each_other(tuned_file):
    jtuned.save_tuned({"platform": "gpu", "put_threads": 3,
                       "wire_compact": False})
    jtuned.save_tuned({"platform": "tpu", "put_threads": 5,
                       "wire_compact": False})
    assert tuned.resolve("cuda", "auto", "auto") == (1, True)
    tuned.save_tuned({"platform": "cuda", "put_threads": 2,
                      "wire_compact": False})
    assert tuned.resolve("cuda", "auto", "auto") == (2, False)
    assert jtuned.resolve("gpu", "auto", "auto") == (3, False)
    assert jtuned.resolve("tpu", "auto", "auto") == (5, False)
    doc = json.loads(tuned_file.read_text())
    assert set(doc) == {"gpu", "tpu", "cuda"}


def test_default_file_is_the_jax_one(monkeypatch):
    monkeypatch.delenv("DMLC_TUNED_CONFIG", raising=False)
    assert tuned.tuned_path() == jtuned.tuned_path()
    assert tuned.tuned_path().endswith(".dmlc_tuned.json")


@pytest.mark.parametrize("writers", ["port", "both"])
def test_save_tuned_concurrent_writers(tuned_file, writers):
    """Twelve writers at once, platform and autotune entries, from one
    package or from both: every entry lands (one lock file)."""
    n = 12
    errors = []
    barrier = threading.Barrier(n)

    def write(i):
        mod = jtuned if writers == "both" and i % 3 == 0 else tuned
        try:
            barrier.wait(timeout=30)
            if i % 2:
                mod.save_tuned({"platform": f"plat{i}", "value": i})
            else:
                mod.save_autotuned(f"key{i}", {"knobs": {"k": i}})
        except Exception as e:                       # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not errors
    doc = json.loads(tuned_file.read_text())
    for i in range(n):
        if i % 2:
            assert doc[f"plat{i}"]["value"] == i
        else:
            assert doc["autotune"][f"key{i}"]["knobs"]["k"] == i
    assert tuned.load_tuned("plat1") == {"platform": "plat1", "value": 1}
    assert tuned.load_autotuned("key0") == {"knobs": {"k": 0}}


def test_autotune_entries_cross_packages(tuned_file):
    cfg = {"knobs": {"parser_threads": 4, "prefetch": 2},
           "objective": 12.5}
    tuned.save_autotuned("a|c8|host", cfg)
    assert jtuned.load_autotuned("a|c8|host") == cfg
    jtuned.save_autotuned("b|c8|serving", {"knobs": {"max_delay_s": 0.004}})
    assert tuned.load_autotuned("b|c8|serving") == \
        {"knobs": {"max_delay_s": 0.004}}
    assert tuned.load_autotuned("missing") is None
    # the section is never taken for a platform entry
    assert tuned.load_tuned("autotune") == jtuned.load_tuned("autotune")
    tuned.update_tuned(lambda d: d.pop("autotune"))
    assert jtuned.load_autotuned("a|c8|host") is None


def test_a_broken_file_reads_as_empty(tuned_file):
    tuned_file.write_text("{not json")
    assert tuned.load_tuned("cuda") is None
    assert tuned.resolve("cuda", "auto", "auto") == (1, True)
    tuned.save_tuned({"platform": "cuda", "put_threads": 2})
    assert tuned.load_tuned("cuda") == {"platform": "cuda", "put_threads": 2}


def test_loader_auto_knobs_resolve_through_the_file(tuned_file, tmp_path):
    from dmlc_core_tpu_torch.data import create_parser
    from dmlc_core_tpu_torch.pipeline import DeviceLoader
    data = tmp_path / "x.libsvm"
    data.write_text("1 3:1 7:0.5\n0 2:1\n")
    with DeviceLoader(create_parser(str(data)), 4, 16, device="cpu") as ld:
        assert ld.wire_compact is False
    tuned.save_tuned({"platform": "cpu", "wire_compact": True})
    # the CPU's wire is never read from the file (the built-in rule)
    with DeviceLoader(create_parser(str(data)), 4, 16, device="cpu") as ld:
        assert ld.wire_compact is False
    with DeviceLoader(create_parser(str(data)), 4, 16, device="cpu",
                      wire_compact=True) as ld:
        assert ld.wire_compact is True
