"""The port's checkpoints (``torch.save`` generations with the JAX
package's sidecars) and their fallback ladder.

``schedule_fingerprint`` gives the JAX package's JSON for the perm slice's
schedule (built on each side by its own ``build_schedule``).  A save and a
restore are bitwise: every parameter, batch-norm buffer and momentum
buffer, and the step cursor.  A flipped byte in the newest generation
quarantines it, the previous one is restored, and a resumed ``train()``
journals one ``recovery`` event; a schedule of another seed raises
``ScheduleMismatch`` and quarantines nothing; three generations are kept.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train.checkpoint import \
    schedule_fingerprint as jax_schedule_fingerprint
from matcha_tpu.train.loop import build_schedule as jax_build_schedule
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.train import (
    TrainConfig,
    build_schedule,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    train,
)
from matcha_tpu_torch.train.checkpoint import (
    CHECKPOINT_FILE,
    MAX_TO_KEEP,
    ScheduleMismatch,
    all_steps,
    latest_step,
    restore_checkpoint,
    restore_with_fallback,
    save_checkpoint,
    schedule_fingerprint,
)

N, B = 4, 2
SLICE = dict(model="resnet20", dataset="synthetic_image", num_workers=16,
             graphid=4, matcha=True, budget=0.5, batch_size=32, seed=9001)


@pytest.mark.parametrize("rows", [None, 17])
def test_schedule_fingerprint_matches_jax(rows):
    port = build_schedule(TrainConfig(**SLICE), 65)
    ref = jax_build_schedule(JaxTrainConfig(**SLICE, gossip_backend="perm"),
                             65)
    got = schedule_fingerprint(port, flag_rows=rows)
    want = jax_schedule_fingerprint(ref, flag_rows=rows)
    assert json.dumps(got) == json.dumps(want)


def _live_state(seed, steps=2):
    """A ResNet-8 train state on the CPU after ``steps`` steps: momentum
    and batch-norm statistics are no longer their initial values."""
    cfg = TrainConfig(model="resnet8", dataset="synthetic_image",
                      num_workers=N, graphid=None, topology="ring",
                      batch_size=B, seed=seed)
    sched = build_schedule(cfg, 8)
    comm = make_decen(sched, "perm", device="cpu")
    lr = make_lr_schedule(0.1, 4)
    opt = make_optimizer(lr)
    model = select_model("resnet8", "synthetic_image", num_workers=N)
    state, flattener = init_train_state(model, N, opt, comm, seed=seed,
                                        device="cpu")
    step = make_train_step(opt, comm, flattener, sched.flags, lr)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        xb = torch.randn(N, B, 32, 32, 3, generator=g)
        yb = torch.randint(0, 10, (N, B), generator=g)
        state, _ = step(state, xb, yb)
    return state, sched


def _tensors(state):
    out = {f"p.{k}": v.detach().clone() for k, v in
           state.model.named_parameters()}
    out.update({f"b.{k}": v.clone() for k, v in state.model.named_buffers()})
    for k, p in state.model.named_parameters():
        out[f"m.{k}"] = state.optimizer.state[p]["momentum_buffer"].clone()
    return out


def test_save_restore_round_trip_is_bitwise(tmp_path):
    live, sched = _live_state(seed=1)
    nbytes = save_checkpoint(str(tmp_path), live, 0, schedule=sched)
    assert nbytes == (tmp_path / "0" / CHECKPOINT_FILE).stat().st_size > 0
    template, _ = _live_state(seed=2, steps=1)
    restored, epoch = restore_checkpoint(str(tmp_path), template,
                                         schedule=sched)
    assert epoch == 0 and restored.step == live.step == 2
    assert restored.comm_carry == live.comm_carry
    want, got = _tensors(live), _tensors(restored)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert sorted(os.listdir(tmp_path)) == ["0", "digest-0.json",
                                            "schedule-0.json"]


def test_restore_refuses_a_cursor_past_the_horizon(tmp_path):
    live, sched = _live_state(seed=1)
    save_checkpoint(str(tmp_path), live, 0)
    short = build_schedule(TrainConfig(model="resnet8", num_workers=N,
                                       graphid=None, topology="ring",
                                       seed=1), 1)
    template, _ = _live_state(seed=2, steps=0)
    with pytest.raises(ScheduleMismatch, match="horizon"):
        restore_checkpoint(str(tmp_path), template, schedule=short)


def test_keeps_the_newest_generations(tmp_path):
    live, sched = _live_state(seed=1, steps=1)
    (tmp_path / ".stale.tmp").write_text("crash leftover")
    for epoch in range(5):
        save_checkpoint(str(tmp_path), live, epoch, schedule=sched)
    kept = list(range(5 - MAX_TO_KEEP, 5))
    assert all_steps(str(tmp_path)) == kept and latest_step(str(tmp_path)) == 4
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([str(e) for e in kept]
                           + [f"digest-{e}.json" for e in kept]
                           + [f"schedule-{e}.json" for e in kept])


RUN = dict(model="mlp", dataset="synthetic", num_workers=N, graphid=None,
           topology="ring", batch_size=8, lr=0.1, warmup=False,
           name="ckpt", dataset_kwargs={"num_train": 96, "num_test": 16})


@pytest.fixture(scope="module")
def two_generations(tmp_path_factory):
    """A 2-epoch CPU run checkpointed every epoch: generations 0 and 1."""
    root = tmp_path_factory.mktemp("gen")
    train(TrainConfig(**RUN, epochs=2, save=True, savePath=str(root),
                      checkpoint_every=1), device="cpu")
    return root


def _copy(src, tmp_path):
    dst = tmp_path / "run"
    shutil.copytree(src, dst)
    return dst


def test_flipped_byte_quarantines_and_falls_back(two_generations, tmp_path):
    root = _copy(two_generations, tmp_path)
    ckpt = root / "ckpt_ckpt"
    newest = ckpt / "1" / CHECKPOINT_FILE
    data = bytearray(newest.read_bytes())
    data[len(data) // 2] ^= 0x01
    newest.write_bytes(bytes(data))
    result = train(TrainConfig(**RUN, epochs=3, save=True,
                               savePath=str(root)),
                   resume_dir=str(ckpt), device="cpu")
    assert [h["epoch"] for h in result.history] == [1, 2]
    recovery = [e for e in result.recorder.events if e["kind"] == "recovery"]
    assert len(recovery) == 1
    assert (recovery[0]["scope"], recovery[0]["action"],
            recovery[0]["epoch"]) == ("checkpoint", "quarantine", 1)
    assert "content hash mismatch" in recovery[0]["reason"]
    quarantined = Path(recovery[0]["quarantined"])
    assert sorted(os.listdir(quarantined)) == ["1", "digest-1.json",
                                               "schedule-1.json"]
    assert all_steps(str(ckpt)) == [0]
    kinds = [e["kind"] for e in result.recorder.events]
    assert kinds.index("recovery") < kinds.index("resume")


def test_unreadable_generation_is_quarantined(two_generations, tmp_path):
    root = _copy(two_generations, tmp_path)
    ckpt = root / "ckpt_ckpt"
    (ckpt / "digest-1.json").unlink()  # unverifiable: torch.load decides
    (ckpt / "1" / CHECKPOINT_FILE).write_bytes(b"not a checkpoint")
    # the run's own initial state (no epoch run) as the template
    template = train(TrainConfig(**RUN, epochs=0), device="cpu").state
    notices = []
    state, epoch = restore_with_fallback(str(ckpt), template,
                                         notices=notices)
    assert epoch == 0 and state.step == 3
    assert [n["step"] for n in notices] == [1]
    assert notices[0]["reason"].startswith("restore failed")


def test_other_seed_raises_and_quarantines_nothing(two_generations,
                                                   tmp_path):
    root = _copy(two_generations, tmp_path)
    ckpt = root / "ckpt_ckpt"
    before = sorted(os.listdir(ckpt))
    with pytest.raises(ScheduleMismatch, match="fingerprint"):
        train(TrainConfig(**{**RUN, "seed": 7}, epochs=3),
              resume_dir=str(ckpt), device="cpu")
    assert sorted(os.listdir(ckpt)) == before


def test_no_generation_raises(tmp_path):
    template, _ = _live_state(seed=2, steps=0)
    with pytest.raises(FileNotFoundError):
        restore_with_fallback(str(tmp_path), template)
    np.testing.assert_equal(all_steps(str(tmp_path / "absent")), [])
