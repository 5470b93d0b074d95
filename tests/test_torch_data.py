"""The port's data layer against the JAX package: host numpy on both sides,
so every array is exactly equal (datasets, partitions, per-epoch batches,
augmentation), and the loop's device-side gather of the training set gives
the same batches as the host loader."""

import numpy as np
import pytest
import torch

from matcha_tpu import data as jdata
from matcha_tpu_torch import data as pdata
from matcha_tpu_torch.train.loop import _epoch_batches

SEED = 9001


def _eq(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("builder", ["synthetic_classification",
                                     "synthetic_images"])
def test_synthetic_datasets_match_jax(builder):
    port = getattr(pdata, builder)(num_train=96, num_test=32, seed=SEED)
    ref = getattr(jdata, builder)(num_train=96, num_test=32, seed=SEED)
    for key in ("x_train", "y_train", "x_test", "y_test"):
        _eq(getattr(port, key), getattr(ref, key))
    assert (port.num_classes, port.name) == (ref.num_classes, ref.name)


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100", "emnist",
                                     "digits", "photo_patches",
                                     "synthetic_image"])
def test_normalize_and_normalized_zero_match_jax(dataset):
    raw = np.random.default_rng(0).integers(0, 256, size=(4, 6, 6, 3))
    if dataset in ("emnist", "digits"):
        raw = raw[..., :1]
    _eq(pdata.normalize(raw, dataset), jdata.normalize(raw, dataset))
    _eq(pdata.normalized_zero(dataset), jdata.normalized_zero(dataset))


@pytest.mark.parametrize("non_iid", [False, True])
@pytest.mark.parametrize("workers", [8, 16])
def test_partition_indices_match_jax(non_iid, workers):
    labels = np.random.default_rng(1).integers(0, 10, size=1000)
    port = pdata.partition_indices(1000, workers, seed=SEED, non_iid=non_iid,
                                   labels=labels)
    ref = jdata.partition_indices(1000, workers, seed=SEED, non_iid=non_iid,
                                  labels=labels)
    assert len(port) == len(ref) == workers
    for a, b in zip(port, ref):
        _eq(a, b)


@pytest.mark.parametrize("augment", [False, True])
def test_worker_batches_epochs_match_jax(augment):
    ds = jdata.synthetic_images(num_train=256, num_test=8, seed=SEED)
    parts = jdata.partition_indices(256, 8, seed=SEED)
    pad = jdata.normalized_zero("synthetic_image")
    port = pdata.WorkerBatches(ds.x_train, ds.y_train, parts, 4, seed=SEED,
                               augment=augment, pad_value=pad)
    ref = jdata.WorkerBatches(ds.x_train, ds.y_train, parts, 4, seed=SEED,
                              augment=augment, pad_value=pad)
    assert port.batches_per_epoch == ref.batches_per_epoch == 8
    for epoch in (0, 3):
        batches = list(port.epoch(epoch))
        assert len(batches) == port.batches_per_epoch
        for (px, py), (rx, ry) in zip(batches, ref.epoch(epoch)):
            _eq(px, rx)
            _eq(py, ry)


def test_augmentation_matches_jax():
    x = np.random.default_rng(2).normal(size=(12, 8, 8, 3)).astype(np.float32)
    pad = jdata.normalized_zero("cifar10")
    port = pdata.augment_crop_flip(x, np.random.default_rng(5), pad_value=pad)
    ref = jdata.augment_crop_flip(x, np.random.default_rng(5), pad_value=pad)
    _eq(port, ref)


def test_device_gather_equals_host_batches():
    ds = pdata.synthetic_images(num_train=128, num_test=8, seed=SEED)
    parts = pdata.partition_indices(128, 4, seed=SEED)
    loader = pdata.WorkerBatches(ds.x_train, ds.y_train, parts, 8, seed=SEED)
    dev = torch.device("cpu")
    gathered = list(_epoch_batches(loader, 1, torch.as_tensor(ds.x_train),
                                   torch.as_tensor(ds.y_train).long(), dev))
    for (gx, gy), (hx, hy) in zip(gathered, loader.epoch(1)):
        _eq(gx.numpy(), hx)
        np.testing.assert_array_equal(gy.numpy(), hy)


def test_loader_rejects_a_batch_larger_than_a_partition():
    parts = pdata.partition_indices(40, 8, seed=SEED)
    with pytest.raises(ValueError, match="exceeds smallest partition"):
        pdata.WorkerBatches(np.zeros((40, 2)), np.zeros(40), parts, 6)
