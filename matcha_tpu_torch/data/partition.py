"""Dataset partitioning across virtual workers.

Port of ``matcha_tpu/data/partition.py`` (a numpy copy).

Parity with the reference ``DataPartitioner`` (the reference's util.py:44-113):

* **Uniform**: seeded global shuffle, equal ``1/N`` splits (util.py:46-59) —
  the only mode the reference actually exercises.
* **Non-IID label skew**: the reference ships a label-skew partitioner that is
  *broken/dormant* — calling it raises a TypeError because ``self`` is passed
  twice (util.py:62, SURVEY.md §2.4) and it reads the deprecated
  ``train_labels``.  Implemented here as intended: each worker draws a
  ``major_ratio`` fraction of its quota from a dominant label (round-robin
  over classes) and fills the rest uniformly from the remaining pool.

Partitions are plain ``int64`` index arrays; every worker keeps the same
number of examples so stacked ``[N, B, ...]`` batches have static shapes.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = [
    "partition_uniform",
    "partition_fractions",
    "partition_label_skew",
    "partition_indices",
]


def partition_uniform(num_examples: int, num_workers: int, seed: int = 1234) -> List[np.ndarray]:
    """Seeded shuffle + equal splits (truncating the remainder, like 1/N
    fractions in util.py:129 truncate via int())."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_examples)
    per = num_examples // num_workers
    return [order[i * per : (i + 1) * per].astype(np.int64) for i in range(num_workers)]


def partition_fractions(
    num_examples: int, fractions: List[float], seed: int = 1234
) -> List[np.ndarray]:
    """Seeded shuffle split by arbitrary fractions — the reference
    ``DataPartitioner(sizes=...)`` general form (util.py:46-59), which its
    call sites only ever use uniformly.  Each part gets ``int(frac·n)``
    examples, consumed in order (truncation semantics match ``int()`` at
    util.py:55-58)."""
    if any(f < 0 for f in fractions) or sum(fractions) > 1.0 + 1e-9:
        raise ValueError(f"fractions must be >= 0 and sum to <= 1, got {fractions}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_examples)
    parts, cursor = [], 0
    for f in fractions:
        take = int(f * num_examples)
        parts.append(order[cursor : cursor + take].astype(np.int64))
        cursor += take
    return parts


def partition_label_skew(
    labels: np.ndarray,
    num_workers: int,
    seed: int = 1234,
    major_ratio: float = 0.4,
) -> List[np.ndarray]:
    """Label-skew non-IID partition (fixed version of util.py:67-113).

    Each worker's quota is ``major_ratio`` drawn from its major class
    (workers assigned to classes round-robin) and the rest drawn uniformly
    from whatever remains.  Degrades gracefully when a class pool runs dry.
    """
    labels = np.asarray(labels)
    n = labels.shape[0]
    rng = np.random.default_rng(seed)
    per = n // num_workers
    major_quota = int(per * major_ratio)

    classes = np.unique(labels)
    pools = {int(c): list(rng.permutation(np.flatnonzero(labels == c))) for c in classes}
    parts: List[np.ndarray] = []
    for w in range(num_workers):
        major = int(classes[w % len(classes)])
        take = []
        pool = pools[major]
        grab = min(major_quota, len(pool))
        take.extend(pool[:grab])
        del pool[:grab]
        parts.append(take)

    # fill remaining quota uniformly from the leftover pool
    leftover = [i for c in pools for i in pools[int(c)]]
    rng.shuffle(leftover)
    cursor = 0
    out = []
    for w in range(num_workers):
        need = per - len(parts[w])
        fill = leftover[cursor : cursor + need]
        cursor += need
        out.append(np.asarray(parts[w] + fill, dtype=np.int64))
    return out


def partition_indices(
    num_examples: int,
    num_workers: int,
    seed: int = 1234,
    non_iid: bool = False,
    labels: np.ndarray | None = None,
    major_ratio: float = 0.4,
) -> List[np.ndarray]:
    if not non_iid:
        return partition_uniform(num_examples, num_workers, seed)
    if labels is None:
        raise ValueError("non-IID partitioning needs labels")
    return partition_label_skew(labels, num_workers, seed, major_ratio)
