"""atomic_publish — the tempfile+rename publish seam.

Port of ``matcha_tpu/utils/atomicio.py`` (:39).  Every file another process
reads while a run writes it (checkpoint sidecars, journal rewrites, the
fault-ledger view) is published through this helper:

1. ``mkstemp`` in the *same directory* as the target (rename is atomic only
   within a filesystem, and mkstemp never collides);
2. write the full payload;
3. ``flush`` + ``fsync``, so the rename never exposes an empty or
   partially persisted file after a power cut;
4. ``os.replace`` onto the target: readers see the old document or the
   new one, never half of either.

IO goes through the ``obs.bestio`` fs seam.  The JAX package's ``barrier``
argument (a chaos kill tap between write and rename) belongs to the chaos
harness, which is not ported.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Union

__all__ = ["atomic_publish"]

#: payloads: text, bytes, or a writer callback ``f -> None`` for payloads
#: that stream themselves (journal line loops)
Payload = Union[str, bytes, Callable]


def atomic_publish(path: str, data: Payload, *, fsync: bool = True,
                   mode: str = "w", prefix: str = None) -> None:
    """Atomically publish ``data`` at ``path`` (see module docstring).

    ``data`` may be ``str``/``bytes`` (written verbatim) or a callable
    taking the open file object.  ``mode`` must be a write mode (``"w"``
    or ``"wb"``).  ``prefix`` names the tempfile family (default derives
    from the target's basename); temp names always end in ``.tmp`` so the
    checkpoint root's stale-temp sweep recognises crash leftovers.
    """
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_publish requires a write mode, got {mode!r}")
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    from ..obs.bestio import get_fs

    fs = get_fs()
    fd, tmp = tempfile.mkstemp(
        prefix=prefix or "." + os.path.basename(path) + ".",
        suffix=".tmp", dir=directory)
    os.close(fd)
    try:
        with fs.open(tmp, mode) as f:
            if callable(data):
                data(f)
            elif isinstance(data, bytes):
                f.write(data)
            else:
                f.write(str(data))
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        fs.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
