"""Checkpoint promotion: consensus eval → signed manifest → serve dir.

Port of ``matcha_tpu/serve/promote.py``.  The manifest (its format, the
sha256 signature over its canonical JSON, the artifact's
``content_hash``) is byte-compatible: a serving directory written by
either package passes the other's ``verify_promoted``.  The artifact holds
the port's own layout (``WorkerFlattener`` order, PyTorch's element order
inside a leaf; ``convert.py`` maps the JAX package's onto it).

The promotion pipeline turns a *training* artifact into
a *serving* artifact with an auditable gate in between:

1. snapshot the **consensus mean** — the average over the worker axis of
   the replicated parameters (the model MATCHA's theory says the fleet
   is contracting toward; the per-worker replicas are its scaffolding);
2. evaluate it on the held-out test set;
3. write the candidate (a flat-parameter ``.npz`` + per-candidate
   manifest) into the serving directory and decide:

   * **promote** — metric is no worse than the last promoted manifest's
     (within ``margin``): the ``MANIFEST.json`` pointer atomically
     re-points to the candidate;
   * **rollback** — metric regressed: the pointer keeps the previous
     promoted checkpoint (the candidate stays on disk for forensics,
     subject to retention) and the decision journals as a v6
     ``promotion`` event with ``action="rollback"``.

Every manifest is *signed*: a sha256 over its canonical JSON (minus the
signature field), which itself covers the artifact's content hash, the
config fingerprint, and the journal offset — so a serving consumer can
refuse a tampered or torn artifact without trusting the directory
(``verify_promoted``; ``serve_torch.py verify`` exits non-zero on it).
Retention: the pointer's target is never pruned, everything else keeps
the newest ``keep`` candidates.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.flatten import tree_order
from ..utils import cross_entropy_loss, top_k_accuracy
from ..utils.atomicio import atomic_publish

__all__ = [
    "MANIFEST_BASENAME",
    "MANIFEST_FORMAT",
    "PromotionTampered",
    "config_fingerprint",
    "consensus_metrics",
    "current_manifest",
    "decide_promotion",
    "prune_serving",
    "snapshot_consensus",
    "verify_promoted",
    "write_candidate",
]

MANIFEST_FORMAT = "matcha-promotion-manifest-v1"
MANIFEST_BASENAME = "MANIFEST.json"


class PromotionTampered(RuntimeError):
    """A serving artifact failed verification — hash or signature
    mismatch, or a manifest naming a file that does not exist.  Serving
    consumers must treat this as "do not serve"."""


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def config_fingerprint(config) -> str:
    """Stable hash of the run configuration a promoted artifact was
    trained under — dataclass or plain dict (non-JSON leaves stringify:
    identity, not round-tripping, is the job here)."""
    snap = dataclasses.asdict(config) if dataclasses.is_dataclass(config) \
        else dict(config)
    return hashlib.sha256(
        json.dumps(snap, sort_keys=True, default=str).encode()).hexdigest()


#: the batch-norm statistics a JAX ``batch_stats`` tree holds (``mean``
#: and ``var``), by the port's buffer names
_STAT_BUFFERS = ("running_mean", "running_var")


def snapshot_consensus(state, flattener) -> Dict[str, np.ndarray]:
    """Host arrays of the consensus-mean model: the worker mean of the
    flat ``[N, D]`` parameter matrix (``params_flat``), and the worker
    mean of each batch-norm statistic (``batch_stats_000``, ...) in the
    JAX package's tree order (``ops.flatten.tree_order``: module path,
    then ``running_mean`` before ``running_var``, as ``mean`` sorts
    before ``var``).  Only the running mean and variance are statistics
    of a JAX ``batch_stats`` tree; other buffers are left out.  One read
    of the device, at the promotion cadence.  A state folded across a
    worker mesh (``train.MeshTrainState``) averages over every card's
    rows, each card's sum gathered on card 0."""
    cards = getattr(state, "cards", None)
    with torch.no_grad():
        if cards is None:
            means = [flattener.flatten(state.params).mean(dim=0)]
            buffers = state.batch_stats
        else:
            means = [_mesh_mean([flattener.flatten(c.params)
                                 for c in cards])]
            buffers = cards[0].batch_stats
        names = [k for k in tree_order(buffers)
                 if k.rsplit(".", 1)[-1] in _STAT_BUFFERS]
        if cards is None:
            means += [buffers[k].mean(dim=0) for k in names]
        else:
            means += [_mesh_mean([c.batch_stats[k] for c in cards])
                      for k in names]
        host = [m.cpu().numpy() for m in means]
    arrays = {"params_flat": np.asarray(host[0], np.float32)}
    for i, arr in enumerate(host[1:]):
        arrays[f"batch_stats_{i:03d}"] = np.asarray(arr, np.float32)
    return arrays


def _mesh_mean(rows) -> torch.Tensor:
    """The worker mean of a tensor folded card by card (``rows[c]`` card
    c's ``[L, ...]``), on card 0: each card's sum gathered there."""
    first = rows[0].device
    total = torch.stack([r.sum(dim=0).to(first) for r in rows]).sum(dim=0)
    return total / sum(r.shape[0] for r in rows)


def consensus_metrics(state, x_test, y_test,
                      batch: int = 256) -> Dict[str, float]:
    """Held-out metrics of the consensus mean on the whole test set.

    The port's workers are the groups of one stacked model, not a vmap
    axis.  The mean model is that model called through
    ``torch.func.functional_call`` with every parameter and buffer
    replaced by its worker mean, kept as a worker axis of one: the layers
    read their worker count from their weights, so the call runs one
    worker, at 1/N of the N-worker evaluation's cost and with no copy of
    the model; the live model is not touched.  ``x_test``/``y_test``:
    tensors (or arrays) of the test set; batches move to the model's
    device.  Each batch's loss and accuracy stay on the device and are
    read once; the weighting by batch size is the JAX package's, in
    float64 on the host.  On a worker mesh the means run over every
    card's rows, and card 0's model evaluates them."""
    cards = getattr(state, "cards", None)
    model = state.model if cards is None else cards[0].model
    dev = next(model.parameters()).device
    with torch.no_grad():
        if cards is None:
            mean = {k: v.mean(dim=0, keepdim=True)
                    for k, v in model.named_parameters()}
            mean.update({k: v.mean(dim=0, keepdim=True)
                         for k, v in model.named_buffers()})
        else:
            stores = [dict(c.model.named_parameters())
                      | dict(c.model.named_buffers()) for c in cards]
            mean = {k: _mesh_mean([st[k] for st in stores])[None]
                    for k in stores[0]}
        was_training = model.training
        model.eval()
        rows, weights = [], []
        try:
            for i in range(0, len(x_test), batch):
                xl = torch.as_tensor(x_test[i:i + batch], device=dev)
                yl = torch.as_tensor(y_test[i:i + batch], device=dev).long()
                logits = torch.func.functional_call(model, mean,
                                                    (xl.unsqueeze(0),))
                labels = yl.unsqueeze(0)
                rows.append(torch.stack([cross_entropy_loss(logits, labels)[0],
                                         top_k_accuracy(logits, labels)[0]]))
                weights.append(len(yl))
        finally:
            model.train(was_training)
        read = torch.stack(rows).cpu().numpy().astype(np.float64)
    w = np.asarray(weights, np.float64)
    return {
        "test_loss": float((read[:, 0] * w).sum() / w.sum()),
        "test_acc": float((read[:, 1] * w).sum() / w.sum()),
    }


def _sign(manifest: dict) -> str:
    body = {k: v for k, v in manifest.items() if k != "signature"}
    return hashlib.sha256(_canonical(body)).hexdigest()


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_json(path: str, obj: dict) -> None:
    # barrier="mid_promote": the chaos kill tap (a no-op unless armed)
    # fires between write and rename — dying there leaves a stale tempfile
    # next to the still-valid previous pointer, the torn-publish state
    # readers must never see half of
    atomic_publish(path, json.dumps(obj, indent=2, sort_keys=True) + "\n",
                   prefix=".manifest.", barrier="mid_promote")


def write_candidate(serving_dir: str, epoch: int, step: int,
                    arrays: Dict[str, np.ndarray], metrics: Dict[str, float],
                    fingerprint: str, journal_offset: int) -> dict:
    """Write the candidate artifact + its signed manifest; returns the
    manifest (NOT yet the serving pointer — ``decide_promotion`` is)."""
    os.makedirs(serving_dir, exist_ok=True)
    params_file = f"promoted-e{epoch:05d}.npz"
    params_path = os.path.join(serving_dir, params_file)
    atomic_publish(params_path, lambda f: np.savez(f, **arrays),
                   mode="wb", prefix=".promoted.")
    manifest = {
        "format": MANIFEST_FORMAT,
        "epoch": int(epoch),
        "step": int(step),
        "params_file": params_file,
        "content_hash": _file_sha256(params_path),
        "config_fingerprint": fingerprint,
        "journal_offset": int(journal_offset),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    manifest["signature"] = _sign(manifest)
    _atomic_json(os.path.join(serving_dir, f"manifest-e{epoch:05d}.json"),
                 manifest)
    return manifest


def current_manifest(serving_dir: str) -> Optional[dict]:
    path = os.path.join(serving_dir, MANIFEST_BASENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def decide_promotion(serving_dir: str, candidate: dict,
                     margin: float = 0.0) -> Tuple[str, dict]:
    """The promote/rollback state machine, one transition per cadence.

    Returns ``(action, serving_manifest)`` where action is ``promote``
    (pointer re-pointed to the candidate) or ``rollback`` (metric
    regressed beyond ``margin`` vs the last promoted manifest: the
    pointer keeps — i.e. re-points to — the previous promoted
    checkpoint).  The pointer write is atomic either way: a reader sees
    the old manifest or the new one, never a torn file.
    """
    previous = current_manifest(serving_dir)
    pointer = os.path.join(serving_dir, MANIFEST_BASENAME)
    if previous is not None:
        prev_acc = float(previous.get("metrics", {}).get("test_acc", 0.0))
        cand_acc = float(candidate.get("metrics", {}).get("test_acc", 0.0))
        if cand_acc < prev_acc - float(margin):
            # regression: the previous promoted manifest stays the
            # serving truth (rewritten through the same atomic path so
            # the decision leaves a fresh mtime audit trail)
            _atomic_json(pointer, previous)
            return "rollback", previous
    _atomic_json(pointer, candidate)
    return "promote", candidate


def verify_promoted(serving_dir: str) -> dict:
    """Verify the serving pointer end-to-end; raises PromotionTampered.

    Checks, in order: pointer exists and parses; its signature matches
    its own canonical content; the artifact it names exists; the
    artifact's bytes hash to the manifest's ``content_hash``."""
    manifest = current_manifest(serving_dir)
    if manifest is None:
        raise PromotionTampered(
            f"no {MANIFEST_BASENAME} under {serving_dir} — nothing promoted")
    if manifest.get("format") != MANIFEST_FORMAT:
        raise PromotionTampered(
            f"unknown manifest format {manifest.get('format')!r}")
    if manifest.get("signature") != _sign(manifest):
        raise PromotionTampered(
            "manifest signature mismatch — the manifest was edited after "
            "promotion")
    params_path = os.path.join(serving_dir, manifest["params_file"])
    if not os.path.exists(params_path):
        raise PromotionTampered(
            f"promoted artifact {manifest['params_file']} is missing")
    digest = _file_sha256(params_path)
    if digest != manifest["content_hash"]:
        raise PromotionTampered(
            f"promoted artifact hash mismatch: manifest says "
            f"{manifest['content_hash'][:12]}…, file is {digest[:12]}…")
    return manifest


def prune_serving(serving_dir: str, keep: int = 3) -> List[str]:
    """Retention: drop all but the newest ``keep`` candidates, never the
    pointer's target.  Returns the basenames removed."""
    pointer = current_manifest(serving_dir) or {}
    pinned = pointer.get("params_file")
    candidates = sorted(
        f for f in os.listdir(serving_dir)
        if f.startswith("promoted-e") and f.endswith(".npz"))
    removed = []
    for f in candidates[:-keep] if keep else candidates:
        if f == pinned:
            continue
        os.unlink(os.path.join(serving_dir, f))
        sidecar = f.replace("promoted-", "manifest-").replace(".npz", ".json")
        if os.path.exists(os.path.join(serving_dir, sidecar)):
            os.unlink(os.path.join(serving_dir, sidecar))
        removed.append(f)
    return removed
