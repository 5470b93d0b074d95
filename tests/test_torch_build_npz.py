"""The port's ``data/build_npz.py`` against the JAX package's converter, on
tiny archives written under ``tmp_path`` in each source layout: CIFAR-10's
python pickle batches, CIFAR-100's pickles, EMNIST-style idx-gzip pairs and
an existing ``.npz``.  Both converters must write the same arrays, exactly
(dtype and values), and the port's CLI the same file."""

import gzip
import pickle
import struct

import numpy as np
import pytest

from matcha_tpu.data import build_npz as jax_build
from matcha_tpu_torch.data import build_npz as port_build
from matcha_tpu_torch.data import load_npz

KEYS = ("x_train", "y_train", "x_test", "y_test")


def _pickle(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _cifar10(root, rng):
    src = root / "cifar-10-batches-py"
    src.mkdir()
    for i in range(1, 6):
        _pickle(src / f"data_batch_{i}", {
            b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
            b"labels": list(rng.integers(0, 10, 3))})
    _pickle(src / "test_batch", {
        b"data": rng.integers(0, 256, (2, 3072), dtype=np.uint8),
        b"labels": [9, 0]})
    return src


def _cifar100(root, rng):
    src = root / "cifar-100-python"
    src.mkdir()
    for name, n in (("train", 4), ("test", 2)):
        _pickle(src / name, {
            b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
            b"fine_labels": list(rng.integers(0, 100, n)),
            b"coarse_labels": list(rng.integers(0, 20, n))})
    return src


def _idx(path, array):
    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def _emnist(root, rng):
    src = root / "emnist"
    src.mkdir()
    for split, n in (("train", 5), ("test", 3)):
        _idx(src / f"emnist-balanced-{split}-images-idx3-ubyte.gz",
             rng.integers(0, 256, (n, 28, 28)))
        _idx(src / f"emnist-balanced-{split}-labels-idx1-ubyte.gz",
             rng.integers(0, 47, n))
    return src


def _npz(root, rng):
    src = root / "in.npz"
    np.savez(src, x_train=rng.integers(0, 256, (4, 8, 8, 1), dtype=np.uint8),
             y_train=np.arange(4), x_test=np.zeros((2, 8, 8, 1), np.uint8),
             y_test=np.arange(2))
    return src


@pytest.mark.parametrize("dataset,make", [
    ("cifar10", _cifar10), ("cifar100", _cifar100), ("emnist", _emnist),
    ("mnist", _npz)])
def test_build_npz_writes_the_jax_converters_arrays(tmp_path, dataset, make):
    src = str(make(tmp_path, np.random.default_rng(0)))
    want_info = jax_build.build_npz(dataset, src, str(tmp_path / "jax.npz"))
    got_info = port_build.build_npz(dataset, src, str(tmp_path / "port.npz"))
    assert {k: v for k, v in got_info.items() if k != "out"} == \
        {k: v for k, v in want_info.items() if k != "out"}
    with np.load(tmp_path / "jax.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        for key in KEYS:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_cli_and_loader(tmp_path, capsys):
    src = _cifar10(tmp_path, np.random.default_rng(1))
    out = tmp_path / "c10.npz"
    port_build.main(["--dataset", "cifar10", "--src", str(src),
                     "--out", str(out)])
    assert "'train': [15, 32, 32, 3]" in capsys.readouterr().out
    ds = load_npz(str(out), dataset="cifar10")
    assert ds.x_train.shape == (15, 32, 32, 3) and ds.num_classes <= 10
    with pytest.raises(KeyError):
        port_build.build_npz("svhn", str(src), str(tmp_path / "x.npz"))
