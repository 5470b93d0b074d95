"""Datasets and worker-batched loading.

Port of ``matcha_tpu/data/datasets.py`` (a numpy copy).  Real datasets load
from local ``.npz`` files (``x_train/y_train/x_test/y_test``, images NHWC);
synthetic Gaussian-cluster datasets give hermetic runs and tests;
``digits`` and ``photo_patches`` read real pixels shipped inside installed
packages (scikit-learn, matplotlib, pygame; decoded with PIL), imported
only when those datasets are built.  The JAX package's native augmentation
kernel is not ported: augmentation keeps the numpy path, which draws the
same random numbers.

The loader yields batches stacked over the worker axis — ``x: [N, B, ...]``,
``y: [N, B]`` — the layout the worker-stacked train step consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

__all__ = [
    "Dataset",
    "synthetic_classification",
    "synthetic_images",
    "uci_digits",
    "photo_patches",
    "load_npz",
    "normalize",
    "augment_crop_flip",
    "WorkerBatches",
    "NORMALIZATION",
]

# (mean, std) per channel — reference transforms (util.py:120-123, 157-160)
NORMALIZATION = {
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "cifar100": ((0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)),
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "emnist": ((0.1307,), (0.3081,)),
    # the JAX package's digits and photo_patches datasets; kept so that
    # normalized_zero agrees with it for every dataset name
    "digits": ((0.3053,), (0.376,)),
    "photo_patches": ((0.3268, 0.3297, 0.4519), (0.2842, 0.2408, 0.2898)),
}


@dataclasses.dataclass
class Dataset:
    x_train: np.ndarray  # [n, H, W, C] float32 (normalized) or raw
    y_train: np.ndarray  # [n] int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    name: str = "dataset"


def normalize(x: np.ndarray, dataset: str) -> np.ndarray:
    """uint8/float [.., H, W, C] → normalized float32."""
    x = np.asarray(x, dtype=np.float32)
    if x.max() > 2.0:  # raw pixel range
        x = x / 255.0
    if dataset in NORMALIZATION:
        mean, std = NORMALIZATION[dataset]
        x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return x


def synthetic_classification(
    num_train: int = 2048,
    num_test: int = 512,
    shape: Tuple[int, ...] = (28, 28, 1),
    num_classes: int = 10,
    seed: int = 0,
    separation: float = 4.0,
) -> Dataset:
    """Gaussian class clusters — linearly separable enough that loss curves
    and consensus behavior are meaningful in seconds."""
    rng = np.random.default_rng(seed)
    dim = int(np.prod(shape))
    centers = rng.normal(size=(num_classes, dim)).astype(np.float32)
    centers *= separation / np.linalg.norm(centers, axis=1, keepdims=True)

    def make(n):
        y = rng.integers(0, num_classes, size=n)
        x = centers[y] + rng.normal(scale=1.0, size=(n, dim)).astype(np.float32)
        return x.reshape((n,) + shape).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = make(num_train)
    x_te, y_te = make(num_test)
    return Dataset(x_tr, y_tr, x_te, y_te, num_classes, name="synthetic")


def synthetic_images(
    num_train: int = 2048, num_test: int = 512, seed: int = 0,
    separation: float = 4.0,
) -> Dataset:
    """CIFAR-shaped synthetic data ([32,32,3], 10 classes)."""
    ds = synthetic_classification(num_train, num_test, (32, 32, 3), 10, seed,
                                  separation=separation)
    return dataclasses.replace(ds, name="synthetic_image")


def uci_digits(num_test: int = 360, seed: int = 0) -> Dataset:
    """Real handwritten-digit pixels, offline: scikit-learn's bundled UCI
    ML handwritten digits (1,797 8×8 grayscale images, 10 classes), the
    JAX package's real-pixel stand-in for the reference's EMNIST/MLP
    configuration.  Pixels are scaled to [0, 1] and standardized with the
    fixed ``digits`` constants; the train/test split is a seeded
    permutation, deterministic for a given ``(num_test, seed)``.  Needs
    scikit-learn, imported here and nowhere else.
    """
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "dataset 'digits' needs scikit-learn (the 'sklearn' package), "
            "which is not installed on this host") from e

    d = load_digits()
    x = (d.images.astype(np.float32) / 16.0)[..., None]  # [1797, 8, 8, 1]
    y = d.target.astype(np.int32)
    if not 0 < num_test < len(y):
        raise ValueError(
            f"num_test={num_test} must leave both splits non-empty "
            f"(dataset has {len(y)} images)"
        )
    mean, std = NORMALIZATION["digits"]
    x = (x - np.float32(mean[0])) / np.float32(std[0])
    order = np.random.default_rng(seed).permutation(len(y))
    test, train = order[:num_test], order[num_test:]
    return Dataset(x[train], y[train], x[test], y[test], 10, name="digits")


# Real photographs shipped inside installed packages (module → relative
# path).  Each becomes one class of photo_patches; paths resolve via
# find_spec so nothing here imports those packages.
_PHOTO_SOURCES = (
    ("china", "sklearn", "datasets/images/china.jpg"),
    ("flower", "sklearn", "datasets/images/flower.jpg"),
    ("hopper", "matplotlib", "mpl-data/sample_data/grace_hopper.jpg"),
    ("fist", "pygame", "examples/data/fist.png"),
    ("canyon", "pygame", "examples/data/arraydemo.bmp"),
    ("freedom", "pygame", "docs/generated/_images/intro_freedom.jpg"),
    ("blade", "pygame", "docs/generated/_images/intro_blade.jpg"),
    ("room", "pygame", "docs/generated/_images/camera_background.jpg"),
)


def photo_patches(
    train_per_class: int = 768,
    test_per_class: int = 128,
    patch: int = 32,
    seed: int = 0,
) -> Dataset:
    """Real-photograph patch classification, offline: one class per real
    photograph shipped with scikit-learn, matplotlib and pygame
    (``_PHOTO_SOURCES``), ``patch²`` RGB crops sampled from it.  Train and
    test crops come from disjoint, adjacent image regions (train pixels end
    at column ``split−1``, test pixels start at ``split``).  Raw [0, 1]
    pixels are standardized with the fixed ``photo_patches`` constants.

    Sources missing from the host are skipped; ``num_classes`` is however
    many resolve (≥ 4 required).  Deterministic for a given seed.  Needs
    PIL to decode the photographs.
    """
    import importlib.util

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "dataset 'photo_patches' needs Pillow (the 'PIL' package), "
            "which is not installed on this host") from e

    rng = np.random.default_rng(seed)
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    label = 0
    names = []
    for name, module, rel in _PHOTO_SOURCES:
        spec = importlib.util.find_spec(module)
        if spec is None or not spec.submodule_search_locations:
            continue
        path = f"{spec.submodule_search_locations[0]}/{rel}"
        try:
            img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        except OSError:  # a source photograph missing or unreadable
            continue
        h, w = img.shape[:2]
        split = int(0.7 * w)
        if h < patch or split - patch < 1 or w - patch < split:
            continue

        def crops(n, x_lo, x_hi):
            ox = rng.integers(x_lo, x_hi + 1, size=n)
            oy = rng.integers(0, h - patch + 1, size=n)
            return np.stack([img[y : y + patch, x : x + patch]
                             for y, x in zip(oy, ox)])

        xs_tr.append(crops(train_per_class, 0, split - patch))
        xs_te.append(crops(test_per_class, split, w - patch))
        ys_tr.append(np.full(train_per_class, label, np.int32))
        ys_te.append(np.full(test_per_class, label, np.int32))
        names.append(name)
        label += 1
    if label < 4:
        raise RuntimeError(
            f"photo_patches found only {label} source photographs "
            f"({names}); need >= 4 for a meaningful task"
        )
    mean, std = NORMALIZATION["photo_patches"]
    norm = lambda x: (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return Dataset(
        norm(np.concatenate(xs_tr)), np.concatenate(ys_tr),
        norm(np.concatenate(xs_te)), np.concatenate(ys_te),
        label, name="photo_patches",
    )


def load_npz(path: str, dataset: str = "cifar10", num_classes: int | None = None) -> Dataset:
    """Load ``x_train/y_train/x_test/y_test`` arrays and apply the reference
    normalization for ``dataset``."""
    with np.load(path) as z:
        x_tr, y_tr = z["x_train"], z["y_train"]
        x_te, y_te = z["x_test"], z["y_test"]
    if x_tr.ndim == 4 and x_tr.shape[1] in (1, 3) and x_tr.shape[-1] not in (1, 3):
        x_tr = x_tr.transpose(0, 2, 3, 1)  # NCHW → NHWC
        x_te = x_te.transpose(0, 2, 3, 1)
    classes = int(num_classes or (int(y_tr.max()) + 1))
    return Dataset(
        normalize(x_tr, dataset),
        y_tr.reshape(-1).astype(np.int32),
        normalize(x_te, dataset),
        y_te.reshape(-1).astype(np.int32),
        classes,
        name=dataset,
    )


def normalized_zero(dataset: str) -> np.ndarray:
    """The value a raw black pixel takes after normalization: ``(0−mean)/std``.
    The reference augments *before* normalizing (RandomCrop pads with 0, then
    Normalize — util.py:118-123); since our pipeline normalizes at load time,
    crop borders must be padded with this value to match that distribution."""
    if dataset not in NORMALIZATION:
        return np.zeros(1, np.float32)
    mean, std = NORMALIZATION[dataset]
    return (-np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _augment_apply_python(
    x: np.ndarray, pad: int, pad_value, offs: np.ndarray, flip: np.ndarray
) -> np.ndarray:
    """Pure-Python apply path for precomputed (offs, flip) draws."""
    n, h, w, c = x.shape
    padded = np.broadcast_to(
        np.asarray(pad_value, np.float32), (n, h + 2 * pad, w + 2 * pad, c)
    ).copy()
    padded[:, pad : pad + h, pad : pad + w, :] = x
    out = np.empty_like(x)
    for i in range(n):
        oy, ox = offs[i]
        img = padded[i, oy : oy + h, ox : ox + w]
        out[i] = img[:, ::-1] if flip[i] else img
    return out


def augment_crop_flip(
    x: np.ndarray,
    rng: np.random.Generator,
    pad: int = 4,
    pad_value: np.ndarray | float = 0.0,
) -> np.ndarray:
    """Random crop (pad ``pad`` with ``pad_value``) + horizontal flip — the
    reference's CIFAR train transform (util.py:118-119).
    Pass ``pad_value=normalized_zero(dataset)`` for post-normalization parity.
    The draws are the JAX package's, in the same order; the copy work is
    the numpy loop."""
    n = x.shape[0]
    offs = rng.integers(0, 2 * pad + 1, size=(n, 2))
    flip = rng.random(n) < 0.5
    return _augment_apply_python(x, pad, pad_value, offs, flip)


class WorkerBatches:
    """Per-epoch iterator over worker-stacked batches.

    Each worker shuffles its own partition independently each epoch (seeded
    by (seed, epoch, worker)), mirroring per-rank DataLoader shuffling in the
    reference (util.py:132-135); batches are stacked to ``[N, B, ...]`` with
    static shapes (partial tail batches dropped, matching drop-last loaders).
    """

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        partitions: List[np.ndarray],
        batch_size: int,
        seed: int = 0,
        augment: bool = False,
        pad_value: np.ndarray | float = 0.0,
    ):
        self.x, self.y = x, y
        self.partitions = partitions
        self.batch_size = int(batch_size)
        self.seed = seed
        self.augment = augment
        self.pad_value = pad_value
        per = min(len(p) for p in partitions)
        self.batches_per_epoch = per // self.batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"batch_size {batch_size} exceeds smallest partition ({per} examples)"
            )

    @property
    def num_workers(self) -> int:
        return len(self.partitions)

    def epoch_indices(self, epoch: int) -> Iterator[np.ndarray]:
        """The ``[N, B]`` example indices of each batch of ``epoch`` — what
        :meth:`epoch` gathers, for callers that gather on a device."""
        B = self.batch_size
        orders = []
        for w, part in enumerate(self.partitions):
            rng = np.random.default_rng((self.seed, epoch, w))
            orders.append(part[rng.permutation(len(part))])
        for b in range(self.batches_per_epoch):
            yield np.stack([o[b * B : (b + 1) * B] for o in orders])

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        aug_rng = np.random.default_rng((self.seed, epoch, 10**6))
        for idx in self.epoch_indices(epoch):
            xb = self.x[idx]  # [N, B, ...]
            if self.augment:
                flat = xb.reshape((-1,) + xb.shape[2:])
                xb = augment_crop_flip(flat, aug_rng, pad_value=self.pad_value).reshape(xb.shape)
            yield xb, self.y[idx]
