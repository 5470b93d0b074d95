"""A resumed run of the port equals the uninterrupted run, bitwise, on the
CPU.

ResNet-8 (batch-norm buffers) on 4 workers of a ring, MATCHA, the perm
backend's plain version: 3 epochs in one run, against 1 epoch with a
checkpoint and then a resume to epoch 3 in the same run folder.  The
parameters, batch-norm buffers, momentum and step cursor are bitwise
equal, and so is every ``history`` value but the timings
(``epoch_time`` and the comm-split timer's ``comm_*``).  The Recorder's
CSVs are byte-identical but for the series the host clock writes
(``recordtime``, ``time``, ``comptime``, ``commtime``), and hold one row
per epoch: the resumed run cuts the folder back to the restored epoch
before it appends.
"""

from pathlib import Path

import pytest
import torch

from matcha_tpu_torch.obs.journal import latest_per_epoch
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train.recorder import SERIES

CLOCK_SERIES = ("recordtime", "time", "comptime", "commtime")
TIMINGS = ("epoch_time", "comm_time", "comm_encode_time",
           "comm_exchange_time")
RUN = dict(model="resnet8", dataset="synthetic_image", num_workers=4,
           graphid=None, topology="ring", matcha=True, budget=0.5,
           batch_size=4, lr=0.1, warmup=False, name="resume", seed=5,
           gossip_backend="perm",
           dataset_kwargs={"num_train": 64, "num_test": 16})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    whole = tmp_path_factory.mktemp("whole")
    cut = tmp_path_factory.mktemp("cut")
    full = train(TrainConfig(**RUN, epochs=3, save=True, savePath=str(whole)),
                 device="cpu")
    first = train(TrainConfig(**RUN, epochs=1, save=True, savePath=str(cut),
                              checkpoint_every=1), device="cpu")
    rest = train(TrainConfig(**RUN, epochs=3, save=True, savePath=str(cut)),
                 resume_dir=str(cut / "resume_ckpt"), device="cpu")
    return full, first, rest


def _state(result):
    state = result.state
    out = {f"p.{k}": v for k, v in state.model.named_parameters()}
    out.update({f"b.{k}": v for k, v in state.model.named_buffers()})
    for k, p in state.model.named_parameters():
        out[f"m.{k}"] = state.optimizer.state[p]["momentum_buffer"]
    return out


def test_resumed_state_is_bitwise_the_uninterrupted_one(runs):
    full, _, rest = runs
    assert rest.state.step == full.state.step
    want, got = _state(full), _state(rest)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_resumed_history_is_bitwise_the_uninterrupted_one(runs):
    full, first, rest = runs
    assert [h["epoch"] for h in first.history + rest.history] == [0, 1, 2]
    for got, want in zip(first.history + rest.history, full.history):
        assert set(got) == set(want)
        for key in set(want) - set(TIMINGS):
            assert got[key] == want[key], key


@pytest.mark.parametrize("kind", SERIES)
def test_resumed_csvs_hold_one_row_per_epoch(runs, kind):
    full, _, rest = runs
    for rank in range(RUN["num_workers"]):
        name = f"dsgd-lr{RUN['lr']}-budget{RUN['budget']}-r{rank}-{kind}.log"
        got = (Path(rest.recorder.folder) / name).read_bytes()
        want = (Path(full.recorder.folder) / name).read_bytes()
        assert len(got.splitlines()) == len(want.splitlines()) == 3
        if kind not in CLOCK_SERIES:
            assert got == want, name


def test_resumed_journal_extends_the_first(runs):
    _, first, rest = runs
    events = rest.recorder.events
    assert events[:len(first.recorder.events)] == first.recorder.events
    # the backend decision follows run_start and resume, as in the JAX loop
    assert [e["kind"] for e in events] == [
        "run_start", "backend", "epoch", "checkpoint", "resume", "backend",
        "epoch", "epoch"]
    assert sorted(latest_per_epoch(events, "epoch")) == [0, 1, 2]
