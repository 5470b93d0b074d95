"""The port's real-pixel datasets against the JAX package's: ``uci_digits``
(scikit-learn's bundled digits) and ``photo_patches`` (photographs shipped
with scikit-learn, matplotlib and pygame, decoded with PIL) are host numpy
on both sides, so every array, its dtype, the class count and the name are
exactly equal, at two seeds.  ``photo_patches`` runs at a small
``train_per_class``; ``train()``'s ``build_dataset`` builds both."""

import numpy as np
import pytest

from matcha_tpu import data as jdata
from matcha_tpu_torch import data as pdata
from matcha_tpu_torch.train import TrainConfig, build_dataset

SMALL_PATCHES = dict(train_per_class=24, test_per_class=6)


def _same_dataset(port, ref):
    for key in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(port, key), getattr(ref, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert (port.num_classes, port.name) == (ref.num_classes, ref.name)


@pytest.mark.parametrize("seed", [0, 9001])
def test_uci_digits_matches_jax(seed):
    _same_dataset(pdata.uci_digits(seed=seed), jdata.uci_digits(seed=seed))


@pytest.mark.parametrize("seed", [0, 9001])
def test_photo_patches_matches_jax(seed):
    port = pdata.photo_patches(seed=seed, **SMALL_PATCHES)
    _same_dataset(port, jdata.photo_patches(seed=seed, **SMALL_PATCHES))
    assert port.num_classes >= 4
    assert port.x_train.shape[1:] == (32, 32, 3)


def test_uci_digits_refuses_an_empty_split():
    for bad in (0, 1797):
        with pytest.raises(ValueError, match="num_test"):
            pdata.uci_digits(num_test=bad)


@pytest.mark.parametrize("dataset,kwargs", [
    ("digits", {"num_test": 200}), ("photo_patches", SMALL_PATCHES)])
def test_build_dataset_builds_the_real_datasets(dataset, kwargs):
    cfg = TrainConfig(dataset=dataset, dataset_kwargs=kwargs, seed=3)
    ref = {"digits": jdata.uci_digits,
           "photo_patches": jdata.photo_patches}[dataset](seed=3, **kwargs)
    _same_dataset(build_dataset(cfg), ref)
