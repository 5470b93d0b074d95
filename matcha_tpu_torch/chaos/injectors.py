"""Disk-state fault injectors: break a run's durable state, precisely.

Port of ``matcha_tpu/chaos/injectors.py`` (:1-167).  Each injector
mutates ONE artifact of a finished (or paused) run the way a real
storage failure would — a cosmic-ray bit flip, a partially
garbage-collected checkpoint generation, a crash mid-append, a crash
mid-publish — and returns an evidence dict (what was broken, where) that
the campaign pins its verdicts against.  All randomness comes from the
caller's ``random.Random``, drawn in the JAX package's order, so a
trial's fault is a pure function of its seed (exact failing-seed replay)
and the same seed breaks the same byte of the same file list in either
package.

The port's generation is one ``torch.save`` file (a zip archive) in its
step directory, where orbax writes many:

* ``delete_checkpoint_file`` therefore always removes the whole payload
  and leaves an empty step directory.  The digest sidecar lists the
  file as missing, so the restore ladder quarantines the directory and
  falls back to the previous generation.
* ``bitflip_checkpoint`` flips a bit inside the zip archive: in a
  member's data (a float of the state, which ``torch.load`` would load
  silently flipped, or a pickle byte) or in the archive's own headers
  (which ``torch.load`` refuses on a CRC or structure error).  Either
  way the digest sidecar catches it before ``torch.load`` reads the file.

The process-boundary injectors (kills at barriers, ENOSPC/slow fs, clock
skew) are NOT here: they cross into the trainer subprocess as
environment variables (``chaos.taps.ENV_KILL``, ``obs.bestio.ENV_FS``,
``obs.bestio.ENV_SKEW``) built by ``chaos.campaign``.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

__all__ = ["checkpoint_files", "bitflip_checkpoint",
           "delete_checkpoint_file", "stale_checkpoint_tempfile",
           "tear_journal_tail", "corrupt_journal_midstream",
           "torn_control_tempfile", "torn_spec_tempfile"]


def checkpoint_files(ckpt_dir: str, step: int) -> List[str]:
    """Every file inside one checkpoint step directory, sorted (so a
    seeded choice over them is stable across hosts)."""
    root = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    out = []
    for base, _dirs, names in os.walk(root):
        for name in names:
            out.append(os.path.join(base, name))
    return sorted(out)


def bitflip_checkpoint(ckpt_dir: str, step: int,
                       rng: random.Random) -> dict:
    """Flip one bit in one file of the step directory — the classic
    silent-corruption case the digest sidecar exists to catch (in the
    port, a bit of the one ``torch.save`` archive)."""
    files = [f for f in checkpoint_files(ckpt_dir, step)
             if os.path.getsize(f) > 0]
    if not files:
        raise FileNotFoundError(
            f"no non-empty files under {ckpt_dir}/{step} to corrupt")
    path = rng.choice(files)
    size = os.path.getsize(path)
    offset = rng.randrange(size)
    bit = rng.randrange(8)
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ (1 << bit)]))
    return {"injector": "bitflip_checkpoint", "path": path,
            "offset": offset, "bit": bit}


def delete_checkpoint_file(ckpt_dir: str, step: int,
                           rng: random.Random) -> dict:
    """Delete one file inside the step directory — the partial-step state
    a kill -9 mid-save (or a half-finished rsync) leaves behind.  The
    port's generation holds one file, so this empties the directory."""
    files = checkpoint_files(ckpt_dir, step)
    if not files:
        raise FileNotFoundError(f"no files under {ckpt_dir}/{step}")
    path = rng.choice(files)
    os.remove(path)
    return {"injector": "delete_checkpoint_file", "path": path}


def stale_checkpoint_tempfile(ckpt_dir: str, step: int) -> dict:
    """Drop a stale sidecar tempfile in the checkpoint root — what a
    crash between a sidecar's tmp-write and its ``os.replace`` leaves."""
    path = os.path.join(os.path.abspath(ckpt_dir),
                        f"digest-{int(step)}.json.tmp")
    # graftlint: disable=GL301 — injector: writes the stale tmp a crashed
    # publish leaves, the state atomic_publish exists to avoid
    with open(path, "w") as f:
        f.write('{"step": %d, "files": {"trunca' % int(step))
    return {"injector": "stale_checkpoint_tempfile", "path": path}


def tear_journal_tail(journal_path: str, rng: random.Random) -> dict:
    """Truncate the journal mid-final-line — the crash-during-append
    state ``read_journal(repair=True)`` must drop (and resume must
    journal as a ``recovery``/``repair``)."""
    # graftlint: disable=GL302 — injector: raw byte surgery on a dead
    # run's journal, not a reader racing a live writer
    with open(journal_path, "rb") as f:
        data = f.read()
    if not data.strip():
        raise ValueError(f"{journal_path} is empty — nothing to tear")
    lines = data.splitlines(keepends=True)
    last = lines[-1]
    # keep at least 1 byte and lose at least the newline + 1 byte, so the
    # remaining tail can never parse as a complete record
    cut = rng.randrange(2, max(len(last), 3))
    # graftlint: disable=GL301,GL302 — injector: deliberately tears the
    # journal tail between lifetimes; the "second writer" IS the fault
    with open(journal_path, "wb") as f:
        f.write(data[:len(data) - cut])
    return {"injector": "tear_journal_tail", "cut_bytes": cut,
            "torn_line": len(lines) - 1}


def corrupt_journal_midstream(journal_path: str,
                              rng: random.Random) -> dict:
    """Overwrite bytes inside an interior line — corruption ``repair=True``
    cannot drop (it only forgives the tail): the salvage-prefix-and-
    quarantine path must handle it."""
    # graftlint: disable=GL302 — injector: raw byte surgery on a dead
    # run's journal, not a reader racing a live writer
    with open(journal_path, "rb") as f:
        data = f.read()
    lines = data.splitlines(keepends=True)
    if len(lines) < 3:
        raise ValueError(f"{journal_path} has {len(lines)} line(s); "
                         f"mid-stream corruption needs >= 3")
    idx = rng.randrange(1, len(lines) - 1)
    line = lines[idx]
    # stomp a span in the middle of the line with bytes that cannot be
    # part of any JSON document (keeps the line count intact)
    span = min(max(len(line) // 3, 4), len(line) - 2)
    start = rng.randrange(1, len(line) - span)
    lines[idx] = line[:start] + b"\xff" * span + line[start + span:]
    # graftlint: disable=GL301,GL302 — injector: plants the mid-stream
    # corruption the salvage path must quarantine; the fault is the point
    with open(journal_path, "wb") as f:
        f.write(b"".join(lines))
    return {"injector": "corrupt_journal_midstream", "line": idx,
            "span": span}


def torn_control_tempfile(control_path: str, version: int = 99) -> dict:
    """Leave a half-written control tempfile next to the control path —
    what a kill mid-``write_control`` leaves.  The watcher reads only the
    published path, so the torn publish must be completely invisible: no
    apply, no reject, no crash."""
    torn = json.dumps({"version": int(version), "budget": 0.25})
    tmp = control_path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(control_path)),
                exist_ok=True)
    # graftlint: disable=GL301 — injector: fabricates the half-written
    # tempfile a kill mid-publish leaves, to prove the watcher ignores it
    with open(tmp, "w") as f:
        f.write(torn[:len(torn) // 2])
    return {"injector": "torn_control_tempfile", "path": tmp,
            "version": int(version)}


def torn_spec_tempfile(spec_path: str) -> dict:
    """Squat a *directory* on the fixed name ``spec_path + ".tmp"``.

    The regression the GL301 bugfix is pinned against: the controller's
    spec publish used to write to exactly this fixed name, so anything
    squatting on it — a crashed sibling's leftover, an operator mkdir, a
    stale artifact — wedged every later relaunch with IsADirectoryError.
    The mkstemp-based ``atomic_publish`` never touches a fixed name, so a
    relaunch must now sail past the squatter untouched."""
    tmp = spec_path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(spec_path)), exist_ok=True)
    os.mkdir(tmp)  # a directory: unlinkable-by-open, worst-case squatter
    return {"injector": "torn_spec_tempfile", "path": tmp}
