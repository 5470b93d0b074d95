"""CHOCO-SGD through the port's ``train()`` on the CPU: the compression
warmup's stages, a resumed run against the uninterrupted one, and a short
acceptance run against the JAX package's ``train()``.

* Warmup (``matcha_tpu/train/loop.py:496-526``): epoch e below
  ``compress_warmup_epochs`` w runs at ratio ``compress_ratio·e/w``, each
  distinct ratio through its own communicator, and the ``{x̂, s}`` carry
  crosses the stages unchanged.
* Resume: a run checkpointed after epoch 0 and resumed equals the
  uninterrupted run bitwise, the carry included (``top_k``, and
  ``random_k``, whose generator state rides the carry).
* Acceptance: ring-8 (zoo graph 5), fixed D-PSGD schedule, the MLP on the
  real ``digits`` pixels, CHOCO at ratio 0.9, 1 epoch of 11 steps, from the
  JAX run's own initial parameters (as ``tests/test_torch_acceptance.py``).
  Both sides compute in float32 and sum in other orders, so the states part
  by f32 rounding from the first step; a coordinate whose magnitude sits
  within that rounding of the k-th largest could then be selected on one
  side only.  Bars: training loss and disagreement within 1e-4 relative,
  test accuracy within one example (1/360), as the decen acceptance run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import load_into_port, to_numpy
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch.train import TrainConfig, loop, train

RUN = dict(model="mlp", dataset="synthetic", num_workers=8, graphid=0,
           batch_size=16, lr=0.1, warmup=False, seed=3,
           communicator="choco", compress_ratio=0.9, consensus_lr=0.2,
           measure_comm_split=False,
           dataset_kwargs={"num_train": 384, "num_test": 32,
                           "shape": (8, 8, 1)})

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its convolutions and products gain nothing
    from more when the file runs alone, and in a full run beside five other
    test processes more threads only contend for the cores.  Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def test_warmup_validation_like_jax():
    """``tests/test_train.py:131``."""
    for bad in (dict(compress_warmup_epochs=2),
                dict(communicator="choco", compress_warmup_epochs=-1)):
        with pytest.raises(ValueError, match="compress_warmup_epochs"):
            JaxTrainConfig(**bad)
        with pytest.raises(ValueError, match="compress_warmup_epochs"):
            TrainConfig(**bad)
    TrainConfig(communicator="choco", compress_warmup_epochs=3,
                compressor="random_k")


def test_warmup_ramps_the_ratio_and_carries_x_hat_across_stages():
    built, steps = [], []
    select = loop.select_communicator

    def recording(name, schedule, **kwargs):
        comm = select(name, schedule, **kwargs)
        built.append(kwargs["ratio"])

        def step(flat, carry, flags_t, alive=None):
            out = comm.step(flat, carry, flags_t, alive)
            steps.append((kwargs["ratio"], carry, out[1]))
            return out

        return dataclasses.replace(comm, step=step)

    cfg = TrainConfig(**RUN, epochs=3, compress_warmup_epochs=2)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(loop, "select_communicator", recording)
        hist = train(cfg, device="cpu").history
    # the default ratio's stage first, then each ramped ratio at its epoch
    assert built == [0.9, 0.0, 0.45]
    bpe = len(steps) // 3
    assert [r for r, _, _ in steps] == [0.0] * bpe + [0.45] * bpe \
        + [0.9] * bpe
    for first in (bpe, 2 * bpe):
        # a stage's first step takes the very carry the last stage left
        assert steps[first][1] is steps[first - 1][2]
    # the keep-all epoch 0 leaves x̂ dense
    assert bool((steps[bpe - 1][2]["x_hat"] != 0).all())
    assert hist[-1]["loss"] < hist[0]["loss"]


def _final(result):
    state = result.state
    out = {f"p.{k}": v for k, v in state.model.named_parameters()}
    out.update({f"c.{k}": v for k, v in state.comm_carry.items()})
    return out


@pytest.mark.parametrize("compressor", ["top_k", "random_k"])
def test_resumed_choco_run_is_bitwise_the_uninterrupted_one(tmp_path,
                                                             compressor):
    cfg = TrainConfig(**RUN, epochs=2, compressor=compressor,
                      compress_warmup_epochs=1, checkpoint_every=1,
                      savePath=str(tmp_path / "whole"))
    whole = train(cfg, device="cpu")
    first = train(dataclasses.replace(cfg, epochs=1,
                                      savePath=str(tmp_path / "cut")),
                  device="cpu")
    rest = train(dataclasses.replace(cfg, savePath=str(tmp_path / "cut"),
                                     checkpoint_every=0),
                 resume_dir=str(tmp_path / "cut" / "experiment_ckpt"),
                 device="cpu")
    assert [h["epoch"] for h in rest.history] == [1]
    assert first.state.comm_carry["x_hat"].any()
    want, got = _final(whole), _final(rest)
    assert set(got) == set(want)
    assert ("c.key" in want) == (compressor == "random_k")
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for k in ("loss", "disagreement", "test_loss_mean"):
        assert rest.history[0][k] == whole.history[1][k]


def test_choco_comm_split_measures_the_encode_path():
    hist = train(TrainConfig(**{**RUN, "measure_comm_split": True},
                             epochs=1), device="cpu").history[0]
    assert 0 < hist["comm_encode_time"] <= hist["comm_time"] \
        <= hist["epoch_time"]
    assert hist["comm_exchange_time"] == pytest.approx(
        hist["comm_time"] - hist["comm_encode_time"])


ACCEPT = dict(model="mlp", dataset="digits", graphid=5, num_workers=8,
              matcha=False, epochs=1, batch_size=16, lr=0.1, warmup=False,
              seed=0, gossip_backend="perm", communicator="choco",
              compress_ratio=0.9, consensus_lr=0.3)


def test_choco_acceptance_against_jax_train():
    ref = jax_train(JaxTrainConfig(**ACCEPT, telemetry=False, health=False))
    init = jax_train(JaxTrainConfig(**{**ACCEPT, "epochs": 0},
                                    telemetry=False, health=False)).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        port = train(TrainConfig(**ACCEPT, sync_init=False, telemetry=False,
                                 health=False), device="cpu")
    got, want = port.history[0], ref.history[0]
    assert set(got) == set(want)
    for key in ("loss", "disagreement"):
        assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (
            key, got[key], want[key])
    assert abs(got["test_acc_mean"] - want["test_acc_mean"]) <= 1 / 360
    assert tuple(port.state.comm_carry["x_hat"].shape) == np.shape(
        ref.state.comm_carry["x_hat"])


def test_cli_parses_the_choco_and_model_flags():
    """``train_torch.py`` takes ``train_tpu.py``'s CHOCO and memory flags
    under their names."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, repo)
    try:
        import train_torch
    finally:
        sys.path.remove(repo)
    cfg, _ = train_torch.parse_args(
        ["--compress", "--ratio", "0.8", "--compressor", "random_k",
         "--consensus-lr", "0.2", "--compress-warmup-epochs", "2",
         "--model", "wrn-16-4", "--remat", "--grad-chunk", "4",
         "--numworkers", "8"])
    assert (cfg.communicator, cfg.compress_ratio, cfg.compressor,
            cfg.consensus_lr, cfg.compress_warmup_epochs, cfg.model,
            cfg.remat, cfg.grad_chunk) == (
        "choco", 0.8, "random_k", 0.2, 2, "wrn-16-4", True, 4)
    cfg, _ = train_torch.parse_args(["--communicator", "choco"])
    assert (cfg.communicator, cfg.grad_chunk, cfg.remat) == (
        "choco", None, False)
    with pytest.raises(SystemExit):
        train_torch.parse_args(["--compressor", "zip"])
