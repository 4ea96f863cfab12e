"""Crash-consistent file commits (copy of the JAX package's ``common.durability``).

``tmp-write → os.replace`` gives *atomicity* (readers never see a torn
file) but not *durability*: without an fsync of the file AND of its
directory, a host power loss after the rename can leave a zero-length —
yet fully "committed" — file on disk, because neither the data pages nor
the directory entry were forced out of the page cache. Every
rename-commit that must survive power loss goes through
:func:`durable_replace` or :func:`durable_write_bytes`:

1. ``fsync(tmp)``  — the file's *bytes* are on stable storage,
2. ``os.replace``  — the atomic switch,
3. ``fsync(dir)``  — the *rename itself* is on stable storage.

Callers that only need atomicity (heartbeats, metric spools — advisory,
rewritten every interval) skip this module; the checkpoint shards,
manifests, commit markers and pointer files of ``serde.checkpoint`` go
through it.

``fsync=False`` exists for benchmarks pricing the fsync cost and for
tests on throwaway dirs; production callers leave it on.
"""

from __future__ import annotations

import json
import os


def fsync_dir(path: str) -> bool:
    """fsync a DIRECTORY so a rename/creation inside it survives power
    loss. Best-effort: some filesystems refuse O_RDONLY dir fsync —
    returns False instead of raising (the data-file fsync already
    happened; this hardens the rename)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return False
    try:
        os.fsync(fd)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def durable_replace(tmp: str, final: str, fsync: bool = True) -> None:
    """``os.replace(tmp, final)`` with the full fsync discipline: the tmp
    file's bytes are synced before the rename, the parent directory after
    it. ``tmp`` and ``final`` must be in the same directory."""
    if fsync:
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(tmp, final)
    if fsync:
        fsync_dir(os.path.dirname(final) or ".")


def durable_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Atomically (and durably, unless ``fsync=False``) install ``data``
    at ``path`` via a pid-suffixed tmp file in the same directory."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            fsync_dir(os.path.dirname(path) or ".")
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def durable_write_json(path: str, payload, fsync: bool = True,
                       **dump_kw) -> None:
    """JSON form of :func:`durable_write_bytes`."""
    durable_write_bytes(path, json.dumps(payload, **dump_kw).encode(),
                        fsync=fsync)
