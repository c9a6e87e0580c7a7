"""The transfer probe (``dmlc_core_tpu_torch.pipeline.probe``, ROADMAP
A.14) on the CPU: it times every configuration in alternating rounds,
persists its winner where ``DeviceLoader``'s ``"auto"`` knobs find it,
and persists nothing while the environment pins a knob.

On the CPU ``resolve`` ignores a tuned file (1 thread, the v2 wire), so
the winner measured here is persisted under ``"cuda"`` to show what the
card's loader would resolve; the probe run as a command persists under
the device it measured.  Every run writes into a tuned file of its own.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from dmlc_core_tpu_torch.pipeline import probe, tuned  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, CAP = 64, 1024


@pytest.fixture
def text(tmp_path):
    rng = np.random.default_rng(0)
    lines = []
    for i in range(700):
        n = int(rng.integers(3, 12))
        idx = np.sort(rng.choice(4096, n, replace=False))
        lines.append(f"{i & 1} " + " ".join(
            f"{j}:{v:.3f}" for j, v in zip(idx, rng.random(n))))
    path = tmp_path / "t.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def tuned_file(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("DMLC_TUNED_CONFIG", str(path))
    for k in probe.PIN_KNOBS:
        monkeypatch.delenv(k, raising=False)
    return path


def test_every_configuration_is_timed_in_alternating_rounds(text,
                                                            monkeypatch):
    order = []
    real = probe._one_pass

    def spy(uri, dev, cfg, rows, cap):
        order.append(cfg)
        return real(uri, dev, cfg, rows, cap)

    monkeypatch.setattr(probe, "_one_pass", spy)
    res = probe.measure(text, batch_rows=ROWS, nnz_cap=CAP, rounds=2,
                        device="cpu")
    cfgs = list(probe.CONFIGS)
    # a warm pass of each wire, then the rounds, every other one reversed
    assert order == [(1, False), (1, True)] + cfgs + cfgs[::-1]
    assert res.batches == 11                    # 700 rows of 64
    assert set(res.runs) == set(cfgs)
    assert all(len(v) == 2 and min(v) > 0 for v in res.runs.values())
    assert res.winner == max(cfgs, key=res.score)


def test_the_winner_is_persisted_and_resolved(text, tuned_file):
    res = probe.measure(text, batch_rows=ROWS, nnz_cap=CAP, rounds=1,
                        device="cpu")
    assert probe.persist(res)
    rec = tuned.load_tuned("cpu")
    assert rec["platform"] == "cpu" and tuned.load_tuned("cuda") is None
    assert (rec["put_threads"], rec["wire_compact"]) == res.winner
    assert (rec["batch_rows"], rec["nnz_cap"]) == (ROWS, CAP)
    assert set(rec["configs"]) == {"pt=1,v2", "pt=2,v2", "pt=1,v3",
                                   "pt=2,v3"}
    # the entry a card's probe writes is what resolve hands its loaders
    tuned.save_tuned({**rec, "platform": "cuda"})
    assert tuned.resolve("cuda", "auto", "auto") == res.winner


@pytest.mark.parametrize("knob,value", [("DMLC_PUT_THREADS", "2"),
                                        ("DMLC_WIRE_COMPACT", "0")])
def test_an_env_pin_stops_persistence(text, tuned_file, monkeypatch, knob,
                                      value):
    res = probe.measure(text, batch_rows=ROWS, nnz_cap=CAP, rounds=1,
                        device="cpu", configs=[(1, False), (2, False)])
    monkeypatch.setenv(knob, value)
    assert probe.pins() == [knob]
    assert not probe.persist(res)
    assert not tuned_file.exists()


def test_the_command_persists_under_its_device(text, tmp_path):
    path = tmp_path / "cli.json"
    env = {k: v for k, v in os.environ.items() if k not in probe.PIN_KNOBS}
    env.update(PYTHONPATH=REPO, DMLC_TUNED_CONFIG=str(path))
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.pipeline.probe", text,
         "--device", "cpu", "--rows", str(ROWS), "--nnz-cap", str(CAP),
         "--rounds", "1"], env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["persisted"] is True and rec["platform"] == "cpu"
    saved = json.loads(path.read_text())["cpu"]
    assert (saved["put_threads"], saved["wire_compact"]) == (
        rec["put_threads"], rec["wire_compact"])
    assert sum(ln.startswith("pt=") for ln in out.stdout.splitlines()) == 4
