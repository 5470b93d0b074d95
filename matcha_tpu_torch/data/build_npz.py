"""Build the ``.npz`` dataset files from locally present archives.

Port of ``matcha_tpu/data/build_npz.py`` (numpy, the same arrays).  The
reference downloads CIFAR/EMNIST through torchvision at train time
(its ``util.py:117-149, 223-251``); this tool reads only local
archives: obtain the standard archives on any machine, convert once, then
load the file with ``datasets.load_npz`` (``TrainConfig.datasetRoot``).

Supported source layouts (auto-detected under ``--src``):

* ``cifar-10-batches-py/`` — the canonical python pickle batches
  (``data_batch_1..5``, ``test_batch``), as unpacked from
  ``cifar-10-python.tar.gz``.
* ``cifar-100-python/`` — ``train``/``test`` pickles from
  ``cifar-100-python.tar.gz``.
* idx-gzip pairs — ``*-images-idx3-ubyte.gz`` + ``*-labels-idx1-ubyte.gz``
  (EMNIST/MNIST family); pass the two train and two test files' directory.
* an existing ``.npz`` with ``x_train/y_train/x_test/y_test`` — validated and
  rewritten (useful to normalize key names from other converters).

CLI: ``python -m matcha_tpu_torch.data.build_npz --dataset cifar10 \
      --src /data/cifar-10-batches-py --out cifar10.npz``
"""

from __future__ import annotations

import argparse
import gzip
import os
import pickle
import struct
from typing import Tuple

import numpy as np

__all__ = ["build_npz", "from_cifar10_batches", "from_cifar100_python", "from_idx_gzip"]


def _load_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    return {k.decode() if isinstance(k, bytes) else k: v for k, v in d.items()}


def _cifar_rows_to_nhwc(rows: np.ndarray) -> np.ndarray:
    """[n, 3072] row-major RGB planes → [n, 32, 32, 3] uint8."""
    return rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.uint8)


def from_cifar10_batches(src: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    xs, ys = [], []
    for i in range(1, 6):
        d = _load_pickle(os.path.join(src, f"data_batch_{i}"))
        xs.append(_cifar_rows_to_nhwc(np.asarray(d["data"])))
        ys.append(np.asarray(d["labels"], np.int32))
    t = _load_pickle(os.path.join(src, "test_batch"))
    return (
        np.concatenate(xs), np.concatenate(ys),
        _cifar_rows_to_nhwc(np.asarray(t["data"])),
        np.asarray(t["labels"], np.int32),
    )


def from_cifar100_python(src: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    tr = _load_pickle(os.path.join(src, "train"))
    te = _load_pickle(os.path.join(src, "test"))
    return (
        _cifar_rows_to_nhwc(np.asarray(tr["data"])),
        np.asarray(tr["fine_labels"], np.int32),
        _cifar_rows_to_nhwc(np.asarray(te["data"])),
        np.asarray(te["fine_labels"], np.int32),
    )


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def from_idx_gzip(src: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """EMNIST/MNIST idx files: finds *train*images/labels + *test*images/labels."""
    names = sorted(os.listdir(src))

    def find(*subs):
        for n in names:
            if all(s in n for s in subs):
                return os.path.join(src, n)
        raise FileNotFoundError(f"no file matching {subs} under {src}")

    def imgs(p):
        x = _read_idx(p)
        return x[..., None]  # [n, H, W] → [n, H, W, 1]

    return (
        imgs(find("train", "images")), _read_idx(find("train", "labels")).astype(np.int32),
        imgs(find("test", "images")), _read_idx(find("test", "labels")).astype(np.int32),
    )


def build_npz(dataset: str, src: str, out: str) -> dict:
    """Convert ``src`` → ``out`` (.npz); returns a summary dict."""
    if src.endswith(".npz"):
        with np.load(src) as z:
            arrays = (z["x_train"], z["y_train"], z["x_test"], z["y_test"])
    elif dataset == "cifar10":
        arrays = from_cifar10_batches(src)
    elif dataset == "cifar100":
        arrays = from_cifar100_python(src)
    elif dataset in ("emnist", "mnist"):
        arrays = from_idx_gzip(src)
    else:
        raise KeyError(f"unknown dataset '{dataset}'")

    x_tr, y_tr, x_te, y_te = arrays
    if x_tr.ndim != 4 or x_tr.shape[0] != y_tr.shape[0]:
        raise ValueError(f"bad shapes: x_train {x_tr.shape}, y_train {y_tr.shape}")
    np.savez_compressed(out, x_train=x_tr, y_train=y_tr, x_test=x_te, y_test=y_te)
    return {
        "out": out, "dataset": dataset,
        "train": list(x_tr.shape), "test": list(x_te.shape),
        "classes": int(y_tr.max()) + 1,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True,
                   choices=["cifar10", "cifar100", "emnist", "mnist"])
    p.add_argument("--src", required=True,
                   help="source directory (pickle batches / idx files) or .npz")
    p.add_argument("--out", required=True, help="output .npz path")
    args = p.parse_args(argv)
    info = build_npz(args.dataset, args.src, args.out)
    print(info)


if __name__ == "__main__":
    main()
