"""Same-directory-temp + ``os.replace`` atomic write helpers.

The port's copy of the JAX package's ``_atomic`` (the port imports
nothing of it). Write into a temp sibling on the SAME filesystem, then
``os.replace`` onto the destination: a crash mid-write leaves the old
file (or nothing), never a truncated artifact that parses as garbage.
:func:`atomic_write` additionally fsyncs the temp file before the
rename and the parent directory after it (:func:`fsync_dir`), so its
contract holds across power loss, not just process death; the
directory-yielding helpers fsync the rename but leave content
durability to their writers. Post-mortem bundle directories
(``telemetry.flightrec.write_bundle``) are written through
:func:`atomic_dir`, and the serving journal will use the same helpers.

Stdlib-only: ``telemetry.flightrec`` (the laptop-side post-mortem
reader) imports this with no torch installed.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable, Iterator

#: process umask, probed once at import (os.umask can only be read by
#: setting it — doing that per write would race other threads' file
#: creation through a umask-0 window)
_UMASK = os.umask(0)
os.umask(_UMASK)


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY fd so the renames/unlinks inside it survive
    power loss, not just process death (a rename is metadata — without
    this it can sit in the journal of a filesystem that already
    persisted a later unlink). Best-effort: platforms/filesystems that
    refuse directory fds (or fsync on them) degrade silently to the
    process-crash guarantee, which ``os.replace`` alone provides."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, write_fn: Callable, *,
                 text: bool = False) -> None:
    """Run ``write_fn(file)`` against a same-directory temp file, then
    ``os.replace`` it onto ``path``. Same-dir matters — ``os.replace``
    is only atomic within one filesystem. The temp file's contents are
    fsynced BEFORE the replace and the parent directory AFTER it, so
    the complete-or-absent contract holds across power loss too — the
    rename is never durable ahead of the data, and never less durable
    than a later unlink.
    The fd is owned (and closed exactly once) by the ``with`` block,
    so a failing replace still reports its own error and the temp
    file is removed. ``text=True`` opens the temp file in text mode
    (utf-8)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(
        dir=parent, prefix=os.path.basename(path) + ".tmp.")
    try:
        # mkstemp creates 0600; restore the umask-derived mode a plain
        # open() would have given, so artifacts stay readable by the
        # same processes that could read them before the atomic switch
        os.fchmod(fd, 0o666 & ~_UMASK)
        if text:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                write_fn(f)
                f.flush()
                os.fsync(f.fileno())
        else:
            with os.fdopen(fd, "wb") as f:
                write_fn(f)
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(parent)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@contextlib.contextmanager
def atomic_path(path: str) -> Iterator[str]:
    """Yield a same-directory temp PATH for an external writer (a
    compiler, a subprocess) to populate, then ``os.replace`` it onto
    ``path`` on clean exit. On an exception the temp file is removed
    and nothing at ``path`` changes. The writer must actually create
    the temp file — exiting without one is an error (an external tool
    that silently produced nothing must not read as success)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        yield tmp
        if not os.path.exists(tmp):
            raise FileNotFoundError(
                f"atomic_path writer produced no file at {tmp}")
        os.replace(tmp, path)
        fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


@contextlib.contextmanager
def atomic_dir(path: str) -> Iterator[str]:
    """Yield a fresh same-parent temp DIRECTORY to populate, then
    ``os.replace`` it onto ``path`` on clean exit — a reader sees the
    complete directory or no directory. On failure the temp tree is
    removed recursively. Raises :class:`FileExistsError` up front when
    ``path`` already exists (``os.replace`` cannot atomically swap a
    non-empty directory; callers pick a fresh name — bundles and
    compacted journals are immutable evidence either way)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"{path} already exists — atomic "
                              f"directory writes need a fresh name")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    os.makedirs(tmp)
    try:
        yield tmp
        os.replace(tmp, path)
        fsync_dir(parent)
    except BaseException:
        # never leave temp droppings next to real artifacts
        for root, dirs, names in os.walk(tmp, topdown=False):
            for n in names:
                os.unlink(os.path.join(root, n))
            for d in dirs:
                os.rmdir(os.path.join(root, d))
        if os.path.isdir(tmp):
            os.rmdir(tmp)
        raise
