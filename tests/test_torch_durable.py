"""The port's durable state (``utils/durable.py``) held against the JAX
package's: the same appends and compactions write byte-equal journal and
snapshot files (``==`` on the bytes), either package loads what the other
wrote to equal ``(snapshot, records)``, a torn tail and a snapshot of
another schema are handled alike, and ``FencedLease`` writes the same
document (every key but ``ts``, a wall-clock stamp) and refuses a fenced
refresh.  Sequences of records come from hypothesis and from seeded
scripts; no tolerance applies (everything is exact)."""

import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")

from dmlc_core_tpu.utils import durable as jdurable  # noqa: E402
from dmlc_core_tpu_torch.utils import durable  # noqa: E402

SCHEMA = "dmlc.test.snapshot/1"

# one journal's life: records appended, compactions with a state between
RECORD = st.dictionaries(
    st.sampled_from(["op", "jobid", "host", "port", "rank", "ts", "x"]),
    st.one_of(st.integers(-5, 10 ** 6), st.text(max_size=6),
              st.floats(allow_nan=False, allow_infinity=False),
              st.lists(st.integers(0, 9), max_size=3)),
    max_size=5)
STEP = st.one_of(st.tuples(st.just("append"), RECORD),
                 st.tuples(st.just("compact"), RECORD))


def _write(mod, prefix: str, steps) -> None:
    j = mod.StateJournal(prefix, snap_schema=SCHEMA)
    for kind, rec in steps:
        if kind == "append":
            j.append(rec)
        else:
            j.compact({"state": rec})
    j.close()


def _bytes(path: str):
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(steps=st.lists(STEP, max_size=12))
def test_same_appends_and_compactions_write_the_same_bytes(tmp_path_factory,
                                                           steps):
    d = tmp_path_factory.mktemp("j")
    _write(jdurable, str(d / "jax" / "j"), steps)
    _write(durable, str(d / "port" / "j"), steps)
    for ext in (".log", ".snap"):
        assert _bytes(str(d / "port" / ("j" + ext))) == \
            _bytes(str(d / "jax" / ("j" + ext))), ext
    got = durable.StateJournal(str(d / "jax" / "j"), snap_schema=SCHEMA)
    want = jdurable.StateJournal(str(d / "port" / "j"), snap_schema=SCHEMA)
    assert got.load() == want.load()
    got.close()
    want.close()


SCRIPTS = {
    "appends": [("append", {"op": "worker", "jobid": "a", "port": 1}),
                ("append", {"op": "assign", "ranks": {"a": 0}})],
    "compacted": [("append", {"op": "x", "n": 1}),
                  ("compact", {"n": 1}),
                  ("append", {"op": "x", "n": 2})],
    "twice": [("compact", {"n": 0}), ("append", {"v": [1, 2]}),
              ("compact", {"n": 2, "w": {"z": None}})],
    "non_json_values": [("append", {"p": (1, 2), "o": object})],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_loads_what_the_other_wrote(tmp_path, name, writer):
    mod, other = (jdurable, durable) if writer == "jax" else (durable,
                                                               jdurable)
    prefix = str(tmp_path / "j")
    _write(mod, prefix, SCRIPTS[name])
    a = other.StateJournal(prefix, snap_schema=SCHEMA)
    b = mod.StateJournal(prefix, snap_schema=SCHEMA)
    assert a.load() == b.load()
    a.close()
    b.close()


@pytest.mark.parametrize("tail", [b'{"op": "to', b'{"op": "x"}',
                                  b"[1, 2]\n", b"not json\n"])
def test_a_torn_or_bad_tail_stops_replay_alike(tmp_path, tail):
    """A line without its newline (a crash mid-append) or one that does
    not decode ends the replay; a JSON line that is not an object is
    skipped; both packages agree."""
    prefix = str(tmp_path / "j")
    _write(durable, prefix, SCRIPTS["appends"])
    with open(prefix + ".log", "ab") as f:
        f.write(tail + b'{"op": "after"}\n' if tail.endswith(b"\n")
                else tail)
    got = durable.StateJournal(prefix, snap_schema=SCHEMA).load()
    want = jdurable.StateJournal(prefix, snap_schema=SCHEMA).load()
    assert got == want
    assert got[1][:2] == [r for _, r in SCRIPTS["appends"]]


def test_a_snapshot_of_another_schema_or_torn_is_discarded(tmp_path):
    prefix = str(tmp_path / "j")
    _write(durable, prefix, [("compact", {"n": 1}),
                             ("append", {"op": "x"})])
    for other in (SCHEMA + "x", None):
        with open(prefix + ".snap", "w") as f:
            if other is None:
                f.write('{"schema": "' + SCHEMA + '", "n"')  # torn
            else:
                json.dump({"schema": other, "n": 1}, f)
        got = durable.StateJournal(prefix, snap_schema=SCHEMA).load()
        assert got == jdurable.StateJournal(prefix,
                                            snap_schema=SCHEMA).load()
        assert got == (None, [{"op": "x"}])


def test_callbacks_count_appends_and_snapshots(tmp_path):
    seen = {"append": 0, "snap": 0}
    j = durable.StateJournal(
        str(tmp_path / "sub" / "j"), snap_schema=SCHEMA,
        on_append=lambda n: seen.__setitem__("append", seen["append"] + n),
        on_snapshot=lambda n: seen.__setitem__("snap", seen["snap"] + n))
    for i in range(3):
        j.append({"i": i})
    assert j.appends_since_snapshot == 3
    j.compact({"i": 2})
    assert j.appends_since_snapshot == 0
    j.close()
    assert seen == {"append": 3, "snap": 1}
    assert os.path.getsize(str(tmp_path / "sub" / "j.log")) == 0


def _lease_doc(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    doc.pop("ts")
    return doc


def test_fenced_lease_writes_the_jax_document_and_refuses_when_fenced(
        tmp_path):
    assert durable.LEASE_SCHEMA == jdurable.LEASE_SCHEMA
    a = durable.FencedLease(str(tmp_path / "a.lease"), ttl_s=30.0)
    b = jdurable.FencedLease(str(tmp_path / "b.lease"), ttl_s=30.0)
    assert a.expired() and b.expired()
    assert a.current_epoch() == b.current_epoch() == 0
    assert a.refresh("primary", 3) and b.refresh("primary", 3)
    assert _lease_doc(a.path) == _lease_doc(b.path)
    assert not a.expired()
    # a standby took over at a higher epoch: the old primary is fenced
    # and writes nothing; each package reads the other's lease
    standby = jdurable.FencedLease(a.path, ttl_s=30.0)
    assert standby.refresh("standby", 4)
    assert a.refresh("primary", 3) is False
    assert a.read()["owner"] == "standby"
    assert a.current_epoch() == standby.current_epoch() == 4
    assert a.refresh("primary", 5)
    assert standby.read() == a.read()
    # stale after its ttl, by the stamp's clock
    assert a.expired(now=a.read()["ts"] + 31.0)
    assert not a.expired(now=a.read()["ts"] + 29.0)


@pytest.mark.parametrize("text", ["", "{", '{"schema": "other/1"}',
                                  "[1]"])
def test_fenced_lease_ignores_a_bad_file_alike(tmp_path, text):
    path = str(tmp_path / "x.lease")
    with open(path, "w") as f:
        f.write(text)
    a = durable.FencedLease(path, ttl_s=1.0)
    b = jdurable.FencedLease(path, ttl_s=1.0)
    assert a.read() is None and b.read() is None
    assert a.expired() and a.current_epoch() == 0
