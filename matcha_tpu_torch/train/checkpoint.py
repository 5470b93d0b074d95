"""Checkpoint and resume with ``torch.save``.

Port of ``matcha_tpu/train/checkpoint.py``, which persists the whole
``TrainState`` through orbax.  Here one generation is one directory per
epoch, ``<dir>/<epoch>/``, holding one ``torch.save`` file
(``CHECKPOINT_FILE``) with the worker-stacked parameters, the batch-norm
buffers, the optimizer's ``state_dict`` (the momentum), ``comm_carry``,
the step cursor ``step`` and the pipelined schedule's ``mix_pending``
(``()`` when eager, ``[N, D]`` or the ``[N, K, D]`` ring).  The file is written into a temporary directory
that is then renamed into place, so a committed generation is never
half-written; at most ``MAX_TO_KEEP`` generations stay, as orbax's
``max_to_keep=3`` keeps.

Beside the generations, under the JAX package's names and published through
``atomic_publish``: ``digest-<epoch>.json``, the sha256 of every file of the
generation, which restore verifies before trusting it, and
``schedule-<epoch>.json``, the schedule fingerprint, which restore holds
the resuming schedule to: the cursor ``step`` means something only
against the flag stream it indexes.

``mix_pending`` restores with whatever shape the file holds, and the
training loop reconciles it with the resuming run's depth; a file written
without the key restores as eager (``()``).  ``torch.load`` needs no
template of the saved shape, so the port has no counterpart of orbax's
``saved_mix_pending_shape`` probe (JAX ``checkpoint.py:266``).  The ring's
``mix_ages`` is never saved: the reconcile rebuilds it from the cursor, as
in the JAX package.

Under elastic membership a third sidecar, ``membership-<epoch>.json``,
records who owned which pool slot and the α re-plan in force
(``load_membership_sidecar``); the state file itself never holds the
membership, which the training loop rebuilds from its trace.  The JAX
package's ladder of older orbax layouts has no counterpart: the port has
only its own format.

A state folded across a worker mesh (``state.MeshTrainState``) is saved
gathered: each card's rows concatenated in worker order (CHOCO's folded
``x̂`` and ``s`` and the pipeline's in-flight deltas too; CHOCO's
generator state as it is), so the file is the
one card's format whatever the number of cards, and a restore into a mesh
slices the ``[N, ...]`` arrays onto the run's cards, the carry as the
template's communicator folds it (a one-card checkpoint resumes on a mesh
and back).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from ..utils.atomicio import atomic_publish
from ..parallel import WorkerBlocks, gather_workers, shard_workers
from .state import MeshTrainState, TrainState

__all__ = ["CHECKPOINT_FILE", "MAX_TO_KEEP", "ScheduleMismatch",
           "all_steps", "checkpoint_digest", "latest_step",
           "load_membership_sidecar", "quarantine_step",
           "restore_checkpoint", "restore_with_fallback", "save_checkpoint",
           "schedule_fingerprint", "verify_checkpoint_digest"]

CHECKPOINT_FILE = "state.pt"
MAX_TO_KEEP = 3  # generations kept, as the JAX package's orbax manager
_SIDECARS = ("schedule-", "membership-", "digest-")


class ScheduleMismatch(ValueError):
    """The resuming schedule disagrees with the checkpointed one — a
    *configuration* error, never storage corruption: the generation
    fallback ladder re-raises it instead of quarantining good data."""


def schedule_fingerprint(schedule, flag_rows: Optional[int] = None) -> dict:
    """Digests of everything the cursor's meaning depends on: the static part
    (matching permutations, α, activation probabilities) and the flag stream.
    ``flag_rows`` digests only the first k rows — how restore compares a
    longer stream against the fingerprint of its shorter ancestor (the
    samplers are prefix-stable).  The same JSON as the JAX package's."""
    static = hashlib.sha256()
    static.update(np.ascontiguousarray(schedule.perms, dtype=np.int32).tobytes())
    static.update(np.float64(schedule.alpha).tobytes())
    static.update(np.ascontiguousarray(schedule.probs, dtype=np.float64).tobytes())
    rows = schedule.iterations if flag_rows is None else int(flag_rows)
    flags = hashlib.sha256(
        np.ascontiguousarray(schedule.flags[:rows], dtype=np.uint8).tobytes()
    )
    return {
        "static_digest": static.hexdigest(),
        "flags_digest": flags.hexdigest(),
        "iterations": rows,
        "num_matchings": int(schedule.num_matchings),
        "num_workers": int(schedule.num_workers),
    }


def _root(directory: str) -> str:
    return os.path.abspath(directory)


def _sidecar_path(directory: str, epoch: int) -> str:
    return os.path.join(_root(directory), f"schedule-{epoch}.json")


def _membership_sidecar_path(directory: str, epoch: int) -> str:
    return os.path.join(_root(directory), f"membership-{epoch}.json")


def _digest_path(directory: str, epoch: int) -> str:
    return os.path.join(_root(directory), f"digest-{epoch}.json")


def load_membership_sidecar(directory: str, epoch: int):
    """The membership recorded beside checkpoint ``epoch``: the pool's
    view (slot → occupant and last owner) and the α re-plan that was
    executing, or ``None`` for a checkpoint without one (every slot
    occupied, scale 1)."""
    path = _membership_sidecar_path(directory, int(epoch))
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def checkpoint_digest(directory: str, epoch: int) -> dict:
    """Content digest of one generation: relative path → sha256, every
    file.  Written as a sidecar at save; restore verifies it before
    trusting the generation, so a flipped bit, a truncation or a deleted
    file fails the comparison before ``torch.load`` reads the file."""
    root = os.path.join(_root(directory), str(int(epoch)))
    files = {}
    for base, _dirs, names in os.walk(root):
        for name in sorted(names):
            path = os.path.join(base, name)
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
            files[os.path.relpath(path, root)] = h.hexdigest()
    return {"step": int(epoch), "files": files}


def verify_checkpoint_digest(directory: str, epoch: int):
    """``None`` when no digest sidecar exists (unverifiable, accepted),
    else the list of problems (empty = intact)."""
    path = _digest_path(directory, int(epoch))
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            saved = json.load(f)["files"]
    except (ValueError, KeyError, OSError) as e:
        return [f"digest sidecar unreadable: {e}"]
    now = checkpoint_digest(directory, epoch)["files"]
    problems = []
    for rel in sorted(set(saved) - set(now)):
        problems.append(f"{rel}: missing")
    for rel in sorted(set(now) - set(saved)):
        problems.append(f"{rel}: unexpected file")
    for rel in sorted(set(saved) & set(now)):
        if saved[rel] != now[rel]:
            problems.append(f"{rel}: content hash mismatch")
    return problems


def quarantine_step(directory: str, epoch: int) -> str:
    """Rename a damaged generation aside — its directory and its sidecars
    move under ``quarantine-<step>[-N]/`` — so the next restore (and the
    next save at the same step) never trips over it, while the evidence
    survives.  Returns the quarantine directory.  The caller journals the
    move (a ``recovery`` event)."""
    root = _root(directory)
    step = int(epoch)
    base = os.path.join(root, f"quarantine-{step}")
    dst, n = base, 1
    while os.path.exists(dst):
        n += 1
        dst = f"{base}-{n}"
    os.makedirs(dst)
    src = os.path.join(root, str(step))
    if os.path.isdir(src):
        os.rename(src, os.path.join(dst, str(step)))
    for prefix in _SIDECARS:
        side = os.path.join(root, f"{prefix}{step}.json")
        if os.path.exists(side):
            os.rename(side, os.path.join(dst, os.path.basename(side)))
    return dst


def all_steps(directory: str):
    """Every committed generation on disk, oldest → newest."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isdir(os.path.join(directory, name)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _gathered_optimizer(cards) -> dict:
    """The cards' optimizer ``state_dict``s as one: each per-parameter
    tensor concatenated in card order (the worker axis), the rest card
    0's."""
    dicts = [card.optimizer.state_dict() for card in cards]
    merged = dict(dicts[0])
    merged["state"] = {
        index: {key: (torch.cat([d["state"][index][key].to(value.device)
                                 for d in dicts])
                      if isinstance(value, torch.Tensor) and value.ndim
                      else value)
                for key, value in entry.items()}
        for index, entry in dicts[0]["state"].items()}
    return merged


def _payload(state) -> dict:
    if isinstance(state, MeshTrainState):
        first = state.mesh.devices[0]
        named = [(dict(card.model.named_parameters()),
                  dict(card.model.named_buffers())) for card in state.cards]
        return {
            "params": {k: torch.cat([p[k].detach().to(first)
                                     for p, _ in named])
                       for k in named[0][0]},
            "buffers": {k: torch.cat([b[k].to(first) for _, b in named])
                        for k in named[0][1]},
            "optimizer": _gathered_optimizer(state.cards),
            "comm_carry": gather_workers(state.comm_carry, first),
            "step": int(state.step),
            "mix_pending": gather_workers(state.mix_pending, first),
        }
    model = state.model
    return {
        "params": {k: v.detach() for k, v in model.named_parameters()},
        "buffers": {k: v.detach() for k, v in model.named_buffers()},
        "optimizer": state.optimizer.state_dict(),
        "comm_carry": state.comm_carry,
        "step": int(state.step),
        "mix_pending": state.mix_pending,
    }


def _commit(root: str, step: int, payload: dict) -> None:
    """Write the generation into a temporary directory, then rename it into
    place.  A generation already at ``step`` is replaced."""
    tmp = tempfile.mkdtemp(prefix=f".{step}.", suffix=".tmp", dir=root)
    try:
        path = os.path.join(tmp, CHECKPOINT_FILE)
        with open(path, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(root, str(step))
        if os.path.isdir(final):
            old = tempfile.mkdtemp(prefix=f".{step}.old.", suffix=".tmp",
                                   dir=root)
            os.rename(final, os.path.join(old, str(step)))
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    schedule=None, membership=None) -> int:
    """Commit ``state`` as generation ``epoch``, keep the newest
    ``MAX_TO_KEEP``, publish its digest (and, given ``schedule``, its
    fingerprint; given ``membership``, a JSON-able dict, the membership)
    sidecar, and prune sidecars of generations no longer on disk and
    crash leftovers.  Returns the bytes of the checkpoint file.
    This is where the state is copied from the card to the host."""
    root = _root(directory)
    os.makedirs(root, exist_ok=True)
    _commit(root, int(epoch), _payload(state))
    steps = all_steps(root)
    for old in steps[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(root, str(old)))
    kept = set(steps[-MAX_TO_KEEP:])
    # chaos barrier (a no-op unless armed): dying here leaves a committed
    # generation with no digest, schedule or membership sidecar — the
    # torn-save state restore accepts as unverifiable
    from ..chaos.taps import maybe_kill

    maybe_kill("mid_save")
    atomic_publish(_digest_path(root, epoch),
                   json.dumps(checkpoint_digest(root, epoch)),
                   prefix=".digest.")
    if schedule is not None:
        # a crash mid-dump must not leave a truncated sidecar that later
        # fails json.load during a legitimate resume
        atomic_publish(_sidecar_path(root, epoch),
                       json.dumps(schedule_fingerprint(schedule)),
                       prefix=".schedule.")
    if membership is not None:
        atomic_publish(_membership_sidecar_path(root, epoch),
                       json.dumps(membership), prefix=".membership.")
    for fname in os.listdir(root):
        path = os.path.join(root, fname)
        if fname.endswith(".tmp"):
            # a crash leftover (a sidecar tempfile or an uncommitted
            # generation): never readable state
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.remove(path)
                except OSError:
                    pass
            continue
        for prefix in _SIDECARS:
            if fname.startswith(prefix) and fname.endswith(".json"):
                try:
                    step = int(fname[len(prefix):-len(".json")])
                except ValueError:
                    continue
                if step not in kept:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
    return os.path.getsize(os.path.join(root, str(int(epoch)),
                                        CHECKPOINT_FILE))


def restore_checkpoint(directory: str, template: TrainState,
                       epoch: Optional[int] = None, schedule=None):
    """Load generation ``epoch`` (default: the newest) into ``template``
    — its model, optimizer, ``comm_carry``, ``step`` and ``mix_pending``
    (``mix_ages`` emptied) are overwritten in place — and return
    ``(state, epoch)``.  The file is read with
    ``weights_only=True`` onto the template's device.

    With ``schedule`` given, the restored cursor is verified against it:
    the cursor must lie within the schedule horizon, and — when the
    checkpoint carries a fingerprint sidecar — the schedule's static part
    must match exactly and its flag stream must reproduce the checkpointed
    stream's prefix.  A mismatch raises :class:`ScheduleMismatch`."""
    step = epoch if epoch is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(_root(directory), str(int(step)), CHECKPOINT_FILE)
    first = (template.mesh.devices[0] if isinstance(template, MeshTrainState)
             else next(template.model.parameters()).device)
    payload = torch.load(path, weights_only=True, map_location=first)
    cursor = int(payload["step"])
    if schedule is not None:
        if cursor > schedule.iterations:
            raise ScheduleMismatch(
                f"restored schedule cursor {cursor} exceeds the resuming "
                f"schedule's horizon {schedule.iterations}; extend the "
                f"schedule (or resume with the one that was checkpointed)"
            )
        sidecar = _sidecar_path(directory, int(step))
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                saved = json.load(f)
            if saved["iterations"] > schedule.iterations:
                raise ScheduleMismatch(
                    f"resuming schedule ({schedule.iterations} steps) is "
                    f"shorter than the checkpointed stream "
                    f"({saved['iterations']} steps); its flag stream cannot "
                    f"be verified — rebuild with the original iterations"
                )
            now = schedule_fingerprint(schedule, flag_rows=saved["iterations"])
            for key in ("static_digest", "flags_digest"):
                if now[key] != saved[key]:
                    what = ("matchings/alpha/probs" if key == "static_digest"
                            else "activation-flag stream")
                    raise ScheduleMismatch(
                        f"schedule {what} differs from the checkpointed "
                        f"schedule (fingerprint mismatch); resuming would "
                        f"de-synchronize the gossip schedule from its "
                        f"solver outputs. Rebuild the schedule with the "
                        f"original graph/budget/seed/sampler."
                    )
    if isinstance(template, MeshTrainState):
        _fold_into(template, payload)
        template.step = cursor
        return template, int(step)
    template.model.load_state_dict(
        {**payload["params"], **payload["buffers"]}, strict=True)
    template.optimizer.load_state_dict(payload["optimizer"])
    template.comm_carry = payload["comm_carry"]
    template.step = cursor
    template.mix_pending = payload.get("mix_pending", ())
    template.mix_ages = ()
    return template, int(step)


def _fold_into(template: MeshTrainState, payload: dict) -> None:
    """Load a gathered payload into a mesh's cards: card c takes rows
    ``c·L..(c+1)·L`` of every parameter, buffer and momentum tensor and
    of the in-flight deltas (their ages are rebuilt from the cursor by the
    loop's reconcile), and the communicator's carry is folded where the
    template's is (a ``WorkerBlocks`` entry); a carry of another
    communicator's shape raises."""
    template.comm_carry = _fold_carry(template.comm_carry,
                                      payload["comm_carry"], template.mesh)
    pending = payload.get("mix_pending", ())
    template.mix_pending = (shard_workers(pending, template.mesh)
                            if isinstance(pending, torch.Tensor) else ())
    template.mix_ages = ()
    rows = template.cards[0].model.num_workers
    for c, card in enumerate(template.cards):
        lo, hi = c * rows, (c + 1) * rows
        card.model.load_state_dict(
            {k: v[lo:hi] for k, v in {**payload["params"],
                                      **payload["buffers"]}.items()},
            strict=True)
        opt = dict(payload["optimizer"])
        opt["state"] = {
            index: {key: (value[lo:hi] if isinstance(value, torch.Tensor)
                          and value.ndim else value)
                    for key, value in entry.items()}
            for index, entry in payload["optimizer"]["state"].items()}
        card.optimizer.load_state_dict(opt)


def _fold_carry(like, saved, mesh):
    """``saved`` (a gathered carry) folded as ``like`` (the run's own
    carry) is: a ``WorkerBlocks`` entry sliced onto the mesh, any other
    entry as saved."""
    if isinstance(like, WorkerBlocks):
        return shard_workers(saved, mesh)
    if isinstance(like, dict) and isinstance(saved, dict) \
            and set(like) == set(saved):
        return {k: _fold_carry(like[k], saved[k], mesh) for k in like}
    if isinstance(like, dict) or isinstance(saved, dict):
        keys = lambda c: sorted(c) if isinstance(c, dict) else c  # noqa
        raise ValueError(f"the checkpoint's communicator carry "
                         f"{keys(saved)!r} does not fit this run's "
                         f"{keys(like)!r}")
    return saved


def restore_with_fallback(directory: str, template: TrainState,
                          schedule=None, notices: Optional[list] = None):
    """Generation fallback ladder: restore the newest checkpoint that is
    both digest-intact and loadable, quarantining every generation that
    fails on the way down.  Returns ``(state, epoch)``.

    * A generation whose digest sidecar disagrees with disk, or whose
      restore raises anything *except* :class:`ScheduleMismatch`, is moved
      aside via :func:`quarantine_step` and appended to ``notices`` as
      ``{"step", "path", "reason"}`` — the caller journals each as a
      ``recovery`` event (scope ``checkpoint``).
    * :class:`ScheduleMismatch` re-raises at once: the *schedule* is
      wrong, not the storage, and the next-oldest generation would fail
      the same way.
    * Raises ``FileNotFoundError`` with no generations on disk, and
      ``ValueError`` listing every failure when all generations fail.
    """
    steps = all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if notices is None:
        notices = []
    errors = []
    for step in reversed(steps):
        problems = verify_checkpoint_digest(directory, step)
        if problems:  # None (no sidecar: unverifiable) passes
            reason = (f"digest verification failed: "
                      f"{'; '.join(problems[:3])}"
                      + (f" (+{len(problems) - 3} more)"
                         if len(problems) > 3 else ""))
            path = quarantine_step(directory, step)
            notices.append({"step": step, "path": path, "reason": reason})
            errors.append(f"step {step}: {reason}")
            continue
        try:
            return restore_checkpoint(directory, template, epoch=step,
                                      schedule=schedule)
        except ScheduleMismatch:
            raise  # config error, not corruption: never quarantine for it
        # the ladder's job: any other restore failure (an unreadable file,
        # a missing key, a shape that does not fit) quarantines this
        # generation and tries the next-oldest
        except Exception as e:  # noqa: BLE001
            reason = f"restore failed: {e!r}"
            path = quarantine_step(directory, step)
            notices.append({"step": step, "path": path, "reason": reason})
            errors.append(f"step {step}: {reason}")
    raise ValueError(
        "every checkpoint generation failed to restore — "
        + "; ".join(errors))
