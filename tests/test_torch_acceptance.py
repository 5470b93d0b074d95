"""The port's acceptance run: the port's ``train()`` against the JAX
package's ``train()`` on one configuration, on the CPU.

Ring-8 (zoo graph 5), the fixed D-PSGD schedule, the MLP on the real
``digits`` pixels (the JAX package's stand-in for the reference's
EMNIST/MLP configuration), the decen communicator on the perm backend,
2 epochs of 11 steps.  The batches are the same by construction: the
port's loader is a copy of the JAX package's, seeded alike.  The initial
parameters are the JAX run's own (its per-worker init followed by its
AllReduce sync), carried over by ``convert.py``: the port's
``init_workers`` is patched, in this test only, to load them, and the
port's sync is off, since the loaded rows are already synced (the port
would average them again, and a mean of equal f32 rows can round by an
ulp).

Tolerances, and why: both sides compute in float32, and XLA and PyTorch
sum the MLP's products in other orders, so every value parts by f32
rounding from the first step on (about 1e-7 relative) and 22 SGD steps
carry it forward.  Per-epoch training loss and disagreement: within 1e-4
relative.  Test accuracy (a mean over workers of each worker's accuracy on
the 360 test images): within one example, 1/360.  At this seed no ReLU
mask flips in float32 by more than that, so float64 is not needed.  The
``history`` keys are the JAX run's.
"""

import numpy as np
import pytest

from _torch_parity import load_into_port, to_numpy
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch.parallel import LAUNCHES
from matcha_tpu_torch.train import TrainConfig, train

CONFIG = dict(model="mlp", dataset="digits", graphid=5, num_workers=8,
              matcha=False, epochs=2, batch_size=16, lr=0.1, warmup=False,
              seed=0, gossip_backend="perm")
REL = 1e-4
ONE_EXAMPLE = 1.0 / 360


@pytest.fixture(scope="module")
def runs():
    ref = jax_train(JaxTrainConfig(**CONFIG, telemetry=False, health=False))
    init = jax_train(JaxTrainConfig(**{**CONFIG, "epochs": 0},
                                    telemetry=False, health=False)).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        before = dict(LAUNCHES)
        port = train(TrainConfig(**CONFIG, sync_init=False, telemetry=False,
                                 health=False), device="cpu")
        assert LAUNCHES == before  # the CPU path: the plain version
    return port.history, ref.history


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_history_keys_match_jax(runs):
    port, ref = runs
    assert [h["epoch"] for h in port] == [h["epoch"] for h in ref] == [0, 1]
    for got, want in zip(port, ref):
        assert set(got) == set(want)


@pytest.mark.parametrize("key", ["loss", "disagreement", "test_loss_mean"])
def test_epoch_metrics_within_1e4_relative(runs, key):
    port, ref = runs
    for got, want in zip(port, ref):
        assert np.isfinite(got[key])
        assert _rel(got[key], want[key]) <= REL, (key, got[key], want[key])


def test_test_accuracy_within_one_example(runs):
    port, ref = runs
    for got, want in zip(port, ref):
        assert abs(got["test_acc_mean"] - want["test_acc_mean"]) \
            <= ONE_EXAMPLE


def test_the_run_learns(runs):
    port, _ = runs
    assert port[1]["loss"] < port[0]["loss"]
    assert port[1]["test_acc_mean"] > 0.5
