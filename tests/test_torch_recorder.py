"""The port's Recorder and run journal against the JAX package's.

Both Recorders, of the same config (``savePath`` included, so each writes
in turn into the one run folder, which the test moves aside between
writes) and fed the same ``add_epoch`` sequence under the same clock
(``time.time`` replaced by a fake in the test), write byte-identical CSVs
and ``ExpDescription`` across two ``save`` calls (the append path), and
the same ``faults.json`` view; ``load_previous`` cuts a run back as the
JAX one does.  A journal written by the port's ``train()`` validates line
by line under the JAX package's ``validate_event``, and
``obs_tpu.py summary`` reads the port's run folder.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from matcha_tpu.obs.journal import validate_event as jax_validate_event
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train.recorder import SERIES as JAX_SERIES
from matcha_tpu.train.recorder import Recorder as JaxRecorder
from matcha_tpu_torch.obs.journal import (
    append_journal_record,
    latest_per_epoch,
    read_journal,
    validate_event,
)
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train.recorder import SERIES, Recorder

REPO = Path(__file__).resolve().parent.parent
N = 4
# the fields whose defaults differ between the two packages, set alike
SAME = dict(name="rec", model="mlp", num_workers=N, lr=0.1, budget=0.5,
            description="recorder parity", gossip_backend="perm",
            telemetry=False, health=False, save=True)


class Clock:
    def __init__(self):
        self.now = 1_000.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time", c)
    return c


def _pair(tmp_path):
    """(port, jax) Recorders of one config, made at the same instant."""
    port = Recorder(TrainConfig(**SAME, savePath=str(tmp_path)), N)
    ref = JaxRecorder(JaxTrainConfig(**SAME, savePath=str(tmp_path)), N)
    assert port.folder == ref.folder
    return port, ref


@contextlib.contextmanager
def _as(rec, side):
    """The run folder holds ``side``'s files (kept aside as
    ``<folder>.<side>``) while the block runs."""
    folder, kept = Path(rec.folder), Path(rec.folder + "." + side)
    if kept.exists():
        kept.rename(folder)
    yield
    if folder.exists():
        folder.rename(kept)


def _save_both(port, ref):
    with _as(port, "port"):
        assert port.save()
    with _as(ref, "jax"):
        assert ref.save()


def _epochs(count, start=0):
    rng = np.random.default_rng(start)
    for e in range(start, start + count):
        yield dict(epoch_time=1.0 + e, comp_time=0.75 + e,
                   comm_time=0.25, train_acc=float(rng.random()),
                   train_loss=float(rng.random() * 3),
                   test_acc=rng.random(N), disagreement=float(rng.random()))


def _feed(clock, recorders, epochs):
    for row in epochs:
        clock.now += 1.5
        for rec in recorders:
            rec.add_epoch(**row)


def _files(rec, side):
    folder = Path(rec.folder + "." + side)
    return {name: (folder / name).read_bytes()
            for name in sorted(os.listdir(folder))
            if name.endswith(".log") or name == "ExpDescription"}


def test_series_match_jax():
    assert SERIES == JAX_SERIES


def test_csvs_and_description_byte_identical_to_jax(tmp_path, clock):
    port, ref = _pair(tmp_path)
    _feed(clock, (port, ref), _epochs(3))
    _save_both(port, ref)
    _feed(clock, (port, ref), _epochs(2, start=3))
    _save_both(port, ref)  # the append path
    got, want = _files(port, "port"), _files(ref, "jax")
    assert len(got) == len(SERIES) * N + 1
    assert got == want
    rows = got["dsgd-lr0.1-budget0.5-r2-tacc.log"].decode().splitlines()
    assert len(rows) == 5


def test_faults_view_matches_jax(tmp_path, clock):
    port, ref = _pair(tmp_path)
    for rec in (port, ref):
        rec.log_fault("plan", name="drill", events=[{"t": 3, "worker": 1}])
    _feed(clock, (port, ref), _epochs(1))
    _save_both(port, ref)
    got = json.loads(Path(port.folder + ".port", "faults.json").read_text())
    want = json.loads(Path(ref.folder + ".jax", "faults.json").read_text())
    assert got == want and len(got["events"]) == 1


@pytest.mark.parametrize("keep", [0, 2, 4, 6])
def test_load_previous_cuts_back_as_jax(tmp_path, clock, keep):
    port, ref = _pair(tmp_path)
    _feed(clock, (port, ref), _epochs(4))
    _save_both(port, ref)
    port2 = Recorder(port.config, N)
    ref2 = JaxRecorder(ref.config, N)
    with _as(port2, "port"):
        loaded = port2.load_previous(keep)
    with _as(ref2, "jax"):
        assert loaded == ref2.load_previous(keep)
    for kind in SERIES:
        np.testing.assert_array_equal(np.asarray(port2.data[kind]),
                                      np.asarray(ref2.data[kind]))
    assert len(port2.events) == len(ref2.events)
    # the resumed run's next save rewrites the cut-back series
    _feed(clock, (port2, ref2), _epochs(1, start=keep))
    _save_both(port2, ref2)
    assert _files(port, "port") == _files(ref, "jax")


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_run")
    cfg = TrainConfig(name="journal", model="mlp", dataset="synthetic",
                      num_workers=N, graphid=None, topology="ring",
                      batch_size=8, epochs=2, lr=0.1, warmup=False,
                      gossip_backend="perm",
                      save=True, savePath=str(root), checkpoint_every=1,
                      dataset_kwargs={"num_train": 128, "num_test": 32})
    result = train(cfg, device="cpu")
    return result, Path(result.recorder.folder)


def test_port_journal_validates_under_jax(port_run):
    result, folder = port_run
    events = read_journal(str(folder / "events.jsonl"))
    # the backend decision follows run_start, as in the JAX loop
    assert [e["kind"] for e in events] == [
        "run_start", "backend", "epoch", "checkpoint", "epoch", "checkpoint"]
    for e in events:
        assert jax_validate_event(e) == [] == validate_event(e)
    assert events == result.recorder.events
    assert sorted(latest_per_epoch(events, "epoch")) == [0, 1]
    assert all(e["bytes"] > 0 and e["seconds"] >= 0
               for e in events if e["kind"] == "checkpoint")


def test_obs_tpu_summary_reads_the_port_run(port_run):
    _, folder = port_run
    out = subprocess.run([sys.executable, "obs_tpu.py", "summary",
                          str(folder)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "(6 events)" in out.stdout
    rows = [line.split() for line in out.stdout.splitlines()]
    assert [r[0] for r in rows if r and r[0].isdigit()] == ["0", "1"]


def test_append_journal_record_validates(tmp_path):
    path = tmp_path / "bench.jsonl"
    event = append_journal_record(str(path), "bench", record={"x": 1})
    assert jax_validate_event(event) == []
    assert read_journal(str(path)) == [event]
    with pytest.raises(ValueError, match="invalid"):
        append_journal_record(str(path), "no_such_kind")
