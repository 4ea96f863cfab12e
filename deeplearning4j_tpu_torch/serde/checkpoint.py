"""Checkpoints of a training run: a crash-consistent, self-healing LINEAGE
(copy of the JAX package's ``serde.checkpoint``, one on-disk format for both).

``TrainingCheckpointer.save`` writes the network's parameters, updater state
and BatchNormalization statistics, its counters and the data iterator's
position; ``restore`` puts them back. The directories it writes are the JAX
package's, byte for byte in every array: a lineage written by either
package restores into the other (tests/test_torch_checkpoint.py).

- **Snapshot, then an async write**: ``save`` copies the state from the card
  to host memory before it returns (the port's updaters change parameters
  in place, so the writer thread must never read a live tensor) and writes
  the files on a background thread. A failed write is re-raised by
  ``wait()`` or the next ``save()``.
- **Generational, two-phase commit**: every ``save()`` writes a fresh
  ``gen-<iteration>/`` directory — a committed checkpoint is never mutated
  in place. The shard carries per-array CRC32s in a self-checksummed
  manifest; then ``train_state.json`` (self-checksummed), the ``COMMIT``
  marker and last the ``LATEST`` pointer are written, each fsynced with its
  directory. A kill at ANY instant leaves either the old or the new
  generation fully restorable. Keep-last-K GC retires old generations but
  never the newest committed one.
- **Verify-then-fallback restore**: ``restore()`` verifies manifests and
  checksums BEFORE touching the network (a failed verify leaves parameters,
  updater state, counters and iterator position bit-identical — restore is
  transactional). An uncommitted, torn or checksum-failing generation is
  quarantined (renamed ``*.corrupt``, ``ckpt_quarantine`` flight event,
  ``tdl_ckpt_verify_failures_total{reason}``, ``tdl_ckpt_quarantined_total``)
  and restore walks back to the newest verifiable generation
  (``tdl_ckpt_fallback_restores_total``, ``ckpt_fallback``), raising
  :class:`CheckpointVerifyError` only when a commit demonstrably existed and
  nothing verifies. An empty lineage is ``False`` — fresh init.
- **Iterator position**: an iterator with ``state()``/``set_state()`` (the
  Array and List iterators) is captured in ``train_state.json``.
- **Preemption**: :class:`PreemptionHandler` saves on SIGTERM before the
  process dies.

On-disk layout (one lineage per tag)::

    <dir>/<tag>/LATEST                  pointer: name of the committed generation
    <dir>/<tag>/gen-00000006/           one generation (never mutated once committed)
        shard_0.npz                     "<path>|0" arrays, "<path>|0|idx" index
                                        ranges, "<path>|0|shape", "__save_id__"
        manifest_0.json                 per-array CRC32s, shard name, save id
        train_state.json                counters, iterator state
        COMMIT                          marker: the manifests verified
    <dir>/<tag>/gen-00000004.corrupt/   a quarantined generation (evidence)

Array paths are the JAX package's state trees: ``params/<layer>/<name>``,
``updater/<slot>/<layer>/<name>``, ``bn/<layer>/{mean,var}`` (a graph's
layer is its node name). A bfloat16 array is stored as its two raw bytes
per element (numpy's ``|V2``, what ``np.savez`` writes for the JAX
package's bfloat16) and read back by reinterpreting those bytes, never by
converting values.

Sharded lineages (``partitioner=``, a ``parallel.partition.Partitioner``;
``ParallelTrainer.checkpointer`` passes the trainer's): each rank of the
mesh writes ``shard_<rank>.npz`` holding its blocks of the parameters and
the updater state (only the first copy of a block the mesh replicates,
JAX's ``replica_id == 0``), each with its index range in the whole array;
the manifests and ``train_state.json`` carry the layout
(``Partitioner.describe()``, the JAX package's identity), and rank 0 commits
once every rank's manifest verifies (``commit_timeout``). A restore under a
partitioner fills each rank's blocks from the saved chunks that overlap them
(a coverage check cell for cell refuses torn or missing chunks); a restore
under another layout than the saved one raises, naming both, unless
``reshard=True``, and then records ``tdl_reshard_bytes_total``,
``tdl_reshard_seconds`` and a ``ckpt_reshard`` flight event. The chunk
indices make a JAX process's several chunks per leaf in one shard file and
the port's one chunk per rank interchangeable: a lineage of either package
restores into the other, under the same layout or resharded, bit for bit.
A network that is not partitioned but trained by a gang of several ranks
(a data-parallel ``MultiProcessTrainer``: every rank holds a replica) saves
collectively too, as the JAX package's replicated arrays do: rank 0 writes
the whole arrays into ``shard_0.npz``, every other rank an empty shard and
its manifest, and rank 0 commits once they are all in.
Without a partitioner a checkpoint of any layout restores by assembling its
chunks into whole arrays on the host (a deliberate difference: the JAX
package asks for ``reshard=True`` there). Pre-lineage flat checkpoints
(``<dir>/<tag>/train_state.json``) restore read-only.

This module imports numpy only: torch is loaded by ``save``/``restore``
(through :mod:`.net_state`), so ``verify_checkpoint`` runs in a process
that never imports torch (a serving pool's router).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import signal
import threading
import time
import zlib
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..common import durability, faults
from ..monitoring import flight
from ..monitoring.registry import get_registry

log = logging.getLogger(__name__)

_STATE_FILE = "train_state.json"
_COMMIT_FILE = "COMMIT"
_POINTER_FILE = "LATEST"
CORRUPT_SUFFIX = ".corrupt"
# optional single-letter suffix: a re-save at an UNCHANGED iteration counter
# must not mutate the committed ``gen-<iter>`` in place, so it lands as
# ``gen-<iter>a`` (… ``z``); lexicographic order ("" < "a" < … < "z") makes
# plain (iteration, name) sorting rank suffixed siblings newest-last
_GEN_RE = re.compile(r"^gen-(\d{8,})([a-z]?)$")


class CheckpointVerifyError(RuntimeError):
    """A committed checkpoint existed for this lineage but no generation
    verifies any more — restoring would resurrect corrupt state, and
    silently training from scratch would discard real progress. The
    failing generations were quarantined; surface this to an operator."""


def _gen_name(iteration: int, suffix: str = "") -> str:
    return f"gen-{int(iteration):08d}{suffix}"


def _fresh_gen_name(lineage: str, iteration: int) -> str:
    """The dir name this save writes into: ``gen-<iteration>``, or the
    first suffixed sibling (``gen-<iteration>a`` …) when that name is
    already a COMMITTED generation — a committed checkpoint is never
    mutated in place, even by a re-save at an unchanged iteration counter.
    Torn (uncommitted) leftovers ARE reused: overwriting a never-committed
    dir is the normal crash-recovery path."""
    for suffix in ("",) + tuple("abcdefghijklmnopqrstuvwxyz"):
        name = _gen_name(iteration, suffix)
        if not _is_committed(os.path.join(lineage, name)):
            return name
    raise RuntimeError(
        f"27 committed generations at iteration {iteration} in {lineage} — "
        "something is re-saving in a loop without training; raise keep_last "
        "GC pressure or advance the iteration counter")


def _leaf_paths(tree, prefix=""):
    """(path, leaf) pairs of a state tree: the checkpoint's path syntax,
    sorted dict keys joined by ``/`` and ``i#`` for the position in a list
    or tuple (``params/0/W``, ``updater/m/0/W``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}{i}#/")
    else:
        yield prefix[:-1], tree


# --------------------------------------------------- lineage: checksums


def _array_crc(a) -> int:
    """CRC32 of an array's raw bytes — the per-array integrity record the
    manifests carry. np roundtrips bytes exactly, so save-side (in-memory)
    and verify-side (npz-loaded) CRCs agree iff the file is intact."""
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _self_checksummed(doc: dict) -> dict:
    """Stamp ``doc`` with a ``crc`` over its canonical JSON — a torn or
    bit-flipped manifest/meta file fails its own checksum instead of
    vouching for shard data it no longer describes."""
    doc = {k: v for k, v in doc.items() if k != "crc"}
    doc["crc"] = zlib.crc32(
        json.dumps(doc, sort_keys=True).encode()) & 0xFFFFFFFF
    return doc


def _self_checksum_ok(doc) -> bool:
    if not isinstance(doc, dict) or "crc" not in doc:
        return False
    body = {k: v for k, v in doc.items() if k != "crc"}
    return (zlib.crc32(json.dumps(body, sort_keys=True).encode())
            & 0xFFFFFFFF) == doc["crc"]


def _lineage_metrics(registry=None) -> SimpleNamespace:
    """Get-or-create the lineage families in the port's registry."""
    r = registry if registry is not None else get_registry()
    return SimpleNamespace(
        verify_failures=r.counter(
            "tdl_ckpt_verify_failures_total",
            "checkpoint generations that failed verification, by reason",
            labels=("reason",)),
        quarantined=r.counter(
            "tdl_ckpt_quarantined_total",
            "checkpoint generations quarantined (renamed *.corrupt) after "
            "failing verification"),
        fallbacks=r.counter(
            "tdl_ckpt_fallback_restores_total",
            "restores that fell back past a failing generation to an older "
            "verifiable one"),
        commits=r.counter(
            "tdl_ckpt_commits_total",
            "checkpoint generations durably committed (all manifests "
            "verified, COMMIT marker written, pointer repointed)"),
        gc_retired=r.counter(
            "tdl_ckpt_gc_retired_total",
            "checkpoint generations retired by keep-last-K GC "
            "(kind=committed beyond K | stale uncommitted)",
            labels=("kind",)),
    )


def _list_generations(lineage: str) -> List[Tuple[int, str]]:
    """(iteration, dirname) of every live (non-quarantined) generation,
    iteration-ascending."""
    out = []
    try:
        names = os.listdir(lineage)
    except OSError:
        return []
    for name in names:
        m = _GEN_RE.match(name)
        if m and os.path.isdir(os.path.join(lineage, name)):
            out.append((int(m.group(1)), name))
    return sorted(out)


def _is_committed(gendir: str) -> bool:
    return os.path.exists(os.path.join(gendir, _COMMIT_FILE))


def _read_pointer(lineage: str) -> Optional[str]:
    try:
        with open(os.path.join(lineage, _POINTER_FILE)) as f:
            name = f.read().strip()
        return name or None
    except OSError:
        return None


def _manifest_matches_save(man, meta) -> bool:
    """A manifest vouches for THIS save only if its save id AND commit
    scope (process_count, layout) agree: a torn leftover from a different
    gang at the very same iteration shares the save id but not the scope."""
    if man is None or int(man.get("save_id", -1)) != int(meta["iteration"]):
        return False
    if int(man.get("process_count", meta["process_count"])) != \
            int(meta["process_count"]):
        return False
    return man.get("layout", meta.get("mesh_layout")) == \
        meta.get("mesh_layout")


def _read_checksummed_json(path: str):
    """(doc, reason): doc is None when missing/torn/checksum-failing."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None, "missing"
    except (OSError, ValueError):
        return None, "unreadable"
    if not _self_checksum_ok(doc):
        return None, "checksum"
    return doc, None


def _verify_generation(gendir: str, deep: bool = True):
    """Full verification of one generation: ``(ok, reason, meta)``.

    Never raises on a bad artifact — the reason string doubles as the
    quarantine/metric label: ``uncommitted``, ``meta_missing``,
    ``meta_crc``, ``manifest_missing``, ``manifest_crc``, ``save_id``,
    ``scope``, ``shard_missing``, ``shard_keys``, ``shard_crc``,
    ``io_error``. ``deep=False`` skips the per-array CRC pass (structure and
    manifests only)."""
    if not _is_committed(gendir):
        return False, "uncommitted", None
    meta, why = _read_checksummed_json(os.path.join(gendir, _STATE_FILE))
    if meta is None:
        return False, ("meta_missing" if why == "missing" else "meta_crc"), None
    try:
        expected = int(meta.get("process_count", 1))
        save_id = int(meta["iteration"])
        for p in range(expected):
            man, why = _read_checksummed_json(
                os.path.join(gendir, f"manifest_{p}.json"))
            if man is None:
                return (False, "manifest_missing" if why == "missing"
                        else "manifest_crc", meta)
            if int(man.get("save_id", -1)) != save_id:
                return False, "save_id", meta
            if not _manifest_matches_save(man, meta):
                return False, "scope", meta
            shard_path = os.path.join(gendir, man.get("shard", ""))
            if not os.path.isfile(shard_path):
                return False, "shard_missing", meta
            if not deep:
                continue
            try:
                with np.load(shard_path) as npz:
                    entries = man.get("entries", {})
                    if set(npz.files) != set(entries):
                        return False, "shard_keys", meta
                    for key, want in entries.items():
                        if _array_crc(npz[key]) != int(want):
                            return False, "shard_crc", meta
            except Exception:
                # a flipped bit usually surfaces as zipfile/zlib errors
                # before our CRC even runs — same verdict either way
                return False, "shard_crc", meta
    except (OSError, KeyError, TypeError, ValueError):
        return False, "io_error", meta
    return True, None, meta


def verify_checkpoint(directory: str, tag: str = "latest", deep: bool = True,
                      registry=None) -> dict:
    """Pre-flight verification of the checkpoint a ``restore()`` would load
    FIRST (the newest committed generation) — WITHOUT quarantining, without
    touching any net, and without falling back: a consumer like
    ``ServingPool.swap_model`` must reject a corrupt artifact, not silently
    ship an older model. Accepts the checkpointer ROOT (``<dir>`` with
    ``<dir>/<tag>/`` underneath), the LINEAGE dir itself (``<dir>/<tag>``),
    or one GENERATION dir (what ``save()``/``committed_generation()``
    return). Legacy flat checkpoints get a structural check (meta parse,
    shard presence, save-id agreement). Returns ``{ok, dir, format,
    generation, iteration, reason, bytes, seconds}``; ``reason`` is
    ``no_checkpoint`` for a path that holds no checkpoint at all."""
    t0 = time.perf_counter()
    m = _lineage_metrics(registry)
    if CORRUPT_SUFFIX in os.path.basename(os.path.normpath(directory)):
        # a quarantined generation handed back in: its basename no longer
        # matches _GEN_RE, so the shape sniffing below would bless the exact
        # bytes the quarantine condemned as a "legacy" flat checkpoint
        m.verify_failures.labels("quarantined").inc()
        return {"ok": False, "dir": directory, "format": "quarantined",
                "generation": os.path.basename(os.path.normpath(directory)),
                "iteration": None, "reason": "quarantined", "bytes": 0,
                "seconds": round(time.perf_counter() - t0, 4)}
    lineage = os.path.join(directory, tag)
    single_gen = None
    if not os.path.isdir(lineage) and os.path.isdir(directory):
        # the caller handed the lineage dir or a generation dir directly
        base = os.path.basename(os.path.normpath(directory))
        if _GEN_RE.match(base):
            single_gen = os.path.normpath(directory)
            lineage = os.path.dirname(single_gen)
        elif (_list_generations(directory)
              or _read_pointer(directory) is not None
              or os.path.exists(os.path.join(directory, _STATE_FILE))):
            lineage = directory
    res = {"ok": False, "dir": lineage, "format": "lineage",
           "generation": None, "iteration": None, "reason": None,
           "bytes": 0, "seconds": 0.0}

    def done():
        res["seconds"] = round(time.perf_counter() - t0, 4)
        if not res["ok"] and res["reason"] not in (None, "no_checkpoint"):
            m.verify_failures.labels(res["reason"]).inc()
        return res

    def judge_generation(gendir, name, it):
        res["format"] = "generation" if single_gen else "lineage"
        res["generation"], res["iteration"] = name, it
        try:
            res["bytes"] = sum(
                os.path.getsize(os.path.join(gendir, f))
                for f in os.listdir(gendir)
                if f.startswith("shard_") and f.endswith(".npz"))
        except OSError:
            pass
        ok, reason, meta = _verify_generation(gendir, deep=deep)
        res["ok"], res["reason"] = ok, reason
        if meta is not None:
            res["iteration"] = int(meta.get("iteration", it))
        return done()

    if single_gen is not None:
        base = os.path.basename(single_gen)
        return judge_generation(single_gen, base,
                                int(_GEN_RE.match(base).group(1)))

    committed = [(it, n) for it, n in _list_generations(lineage)
                 if _is_committed(os.path.join(lineage, n))]
    if committed:
        it, name = committed[-1]
        return judge_generation(os.path.join(lineage, name), name, it)

    if os.path.exists(os.path.join(lineage, _STATE_FILE)):
        res["format"] = "legacy"
        try:
            with open(os.path.join(lineage, _STATE_FILE)) as f:
                meta = json.load(f)
            res["iteration"] = int(meta["iteration"])
            shards = [f for f in os.listdir(lineage)
                      if f.startswith("shard_") and f.endswith(".npz")]
            if len(shards) < int(meta.get("process_count", 1)):
                res["reason"] = "shard_missing"
                return done()
            for fname in shards:
                path = os.path.join(lineage, fname)
                res["bytes"] += os.path.getsize(path)
                with np.load(path) as npz:
                    sid = (int(npz["__save_id__"])
                           if "__save_id__" in npz.files else None)
                if sid is not None and sid != int(meta["iteration"]):
                    res["reason"] = "save_id"
                    return done()
        except Exception:
            res["reason"] = "io_error"
            return done()
        res["ok"] = True
        return done()

    res["reason"] = "no_checkpoint"
    return done()


def lineage_state(directory: str, tag: str = "latest") -> dict:
    """Machine-readable lineage inventory: which generations are committed,
    which are torn, which were quarantined, and where the pointer points."""
    lineage = os.path.join(directory, tag)
    out = {"dir": lineage, "format": "lineage", "pointer": None,
           "legacy_flat": False, "committed": [], "uncommitted": [],
           "quarantined": [], "newest_committed": None}
    if not os.path.isdir(lineage):
        out["format"] = "empty"
        return out
    if os.path.exists(os.path.join(lineage, _STATE_FILE)):
        # a pre-lineage flat checkpoint (possibly coexisting with newer
        # generations after an upgrade — generations outrank it on restore)
        out["legacy_flat"] = True
        if not _list_generations(lineage):
            out["format"] = "legacy"
            return out
    out["pointer"] = _read_pointer(lineage)
    for it, name in _list_generations(lineage):
        bucket = ("committed"
                  if _is_committed(os.path.join(lineage, name))
                  else "uncommitted")
        out[bucket].append({"generation": name, "iteration": it})
    try:
        out["quarantined"] = sorted(
            n for n in os.listdir(lineage)
            if CORRUPT_SUFFIX in n and os.path.isdir(os.path.join(lineage, n)))
    except OSError:
        pass
    if out["committed"]:
        out["newest_committed"] = out["committed"][-1]["generation"]
    return out


def _rename_corrupt(gendir: str) -> Optional[str]:
    """Rename a generation to ``*.corrupt`` (``.corrupt.<n>`` when taken);
    the new path, or None when the rename lost a race."""
    target = gendir + CORRUPT_SUFFIX
    n = 1
    while os.path.exists(target):
        target = f"{gendir}{CORRUPT_SUFFIX}.{n}"
        n += 1
    try:
        os.replace(gendir, target)  # quarantine rename: losing it to power
        # loss re-detects the same corruption next boot
    except OSError as e:
        log.warning("could not quarantine %s: %s", gendir, e)
        return None
    return target


def quarantine_generation(gendir: str, reason: str, tag: str = "latest",
                          registry=None) -> Optional[str]:
    """Quarantine for a caller OUTSIDE a restore walk: rename to
    ``*.corrupt`` (evidence kept, poison off the restore path), bump the
    verify-failure/quarantine counters, flight-record the rename. Returns
    the quarantine path, or None when the rename lost a race."""
    name = os.path.basename(gendir)
    target = _rename_corrupt(gendir)
    if target is None:
        return None
    durability.fsync_dir(os.path.dirname(gendir))
    m = _lineage_metrics(registry)
    m.verify_failures.labels(reason).inc()
    m.quarantined.inc()
    flight.record("ckpt_quarantine", tag=tag, generation=name, reason=reason,
                  renamed_to=os.path.basename(target))
    log.error("checkpoint generation %s quarantined -> %s (%s)", name,
              os.path.basename(target), reason)
    return target


def clone_generation(src_gendir: str, dst_directory: str, tag: str = "latest",
                     *, deep: bool = True, durable: bool = True,
                     registry=None) -> dict:
    """Copy ONE verified committed generation into ANOTHER lineage (a
    population-based-training exploit): the source is (deep-)verified first
    and a failure raises :class:`CheckpointVerifyError` with ``.reason``,
    leaving the destination untouched. The destination name comes from
    ``_fresh_gen_name``; the commit order is that of a save (files, then the
    COMMIT marker, then the pointer), so a kill mid-clone leaves a torn dir
    that restore quarantines."""
    t0 = time.perf_counter()
    ok, reason, meta = _verify_generation(src_gendir, deep=deep)
    if not ok:
        _lineage_metrics(registry).verify_failures.labels(reason).inc()
        err = CheckpointVerifyError(
            f"clone source {src_gendir} failed verification ({reason})")
        err.reason = reason
        raise err
    iteration = int(meta["iteration"])
    lineage = os.path.join(dst_directory, tag)
    os.makedirs(lineage, exist_ok=True)
    gen = _fresh_gen_name(lineage, iteration)
    ckdir = os.path.join(lineage, gen)
    if os.path.isdir(ckdir):  # torn leftover owns the name: replace it whole
        shutil.rmtree(ckdir)
    os.makedirs(ckdir)
    faults.fault_point("ckpt_write", iteration)
    nbytes = 0
    for fname in sorted(os.listdir(src_gendir)):
        src = os.path.join(src_gendir, fname)
        if fname == _COMMIT_FILE or fname.endswith(".tmp") \
                or not os.path.isfile(src):
            continue
        with open(src, "rb") as f:
            data = f.read()
        durability.durable_write_bytes(os.path.join(ckdir, fname), data,
                                       fsync=durable)
        nbytes += len(data)
    if durable:
        durability.fsync_dir(ckdir)
    durability.durable_write_json(
        os.path.join(ckdir, _COMMIT_FILE),
        {"generation": gen, "iteration": iteration,
         "process_count": int(meta.get("process_count", 1)),
         "cloned_from": os.path.basename(src_gendir),
         "cloned_from_path": src_gendir,
         "wall": time.time()},  # human-facing timestamp
        fsync=durable)
    durability.durable_write_bytes(
        os.path.join(lineage, _POINTER_FILE), (gen + "\n").encode(),
        fsync=durable)
    _lineage_metrics(registry).commits.inc()
    dt = time.perf_counter() - t0
    flight.record("ckpt_commit", tag=tag, generation=gen,
                  iteration=iteration,
                  shards=int(meta.get("process_count", 1)),
                  seconds=round(dt, 4),
                  cloned_from=os.path.basename(src_gendir))
    return {"generation": gen, "iteration": iteration, "path": ckdir,
            "bytes": nbytes, "seconds": dt, "source": src_gendir}


class TrainingCheckpointer:
    """save/restore of (net state, train counters, iterator position) for a
    port ``MultiLayerNetwork`` or ``ComputationGraph``.

    Knobs: ``async_write`` (the disk write on a background thread),
    ``keep_last`` (committed generations retained by GC, >= 1), ``durable``
    (fsync files AND directories on every rename-commit; off only for
    benchmarks pricing the fsync), ``partitioner`` (a sharded lineage of a
    partitioned network, module docstring), ``reshard`` (the default of
    ``restore(reshard=)``), ``commit_timeout`` (rank 0's bounded wait for
    the other ranks' manifests). ``restore`` always runs the full per-array
    CRC pass before loading: the JAX package's ``verify_on_restore=False``
    waits for a benchmark that prices that pass. ``save()`` of a partitioned
    network is collective: every rank of its mesh calls it at the same
    iteration."""

    def __init__(self, directory: str, async_write: bool = True,
                 partitioner=None, reshard: bool = False,
                 keep_last: int = 3, durable: bool = True, commit_timeout: float = 300.0):
        if partitioner is not None:
            from ..parallel.partition import Partitioner

            if not isinstance(partitioner, Partitioner):
                raise TypeError(f"partitioner={partitioner!r}: a parallel.partition.Partitioner "
                                "(or None)")
        self.dir = directory
        self.async_write = async_write
        self.partitioner = partitioner
        self.reshard = reshard
        self.keep_last = max(1, int(keep_last))
        self.durable = durable
        self.commit_timeout = commit_timeout
        self._writer: Optional[threading.Thread] = None
        # a failed async write must not vanish on the background thread: it
        # is captured here and re-raised from wait() / the next save()
        self._error: Optional[BaseException] = None
        self._failures = get_registry().counter(
            "tdl_checkpoint_failures_total",
            "Checkpoint writes that raised (sync or async)")
        self._save_hist = get_registry().histogram(
            "tdl_ckpt_save_seconds",
            "Wall time of one checkpoint shard write (disk side; async "
            "writes observed on the background thread)")
        self._m = _lineage_metrics()
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, net, iterator=None, tag: str = "latest") -> str:
        """Snapshot the network's state to host memory (this call returns
        only once every tensor has left the card), then write generation
        ``gen-<iteration>`` — on a background thread with ``async_write``.
        Returns the generation's directory."""
        from .net_state import snapshot

        # join the previous async write FIRST (also re-raises its pending
        # failure): _fresh_gen_name must probe committed-ness AFTER the
        # in-flight writer's commit lands
        self.wait()
        lineage = os.path.join(self.dir, tag)
        gen = _fresh_gen_name(lineage, int(net.iteration))
        ckdir = os.path.join(lineage, gen)
        os.makedirs(ckdir, exist_ok=True)
        arrays = snapshot(net)  # device→host NOW: later steps update in place
        chunks, proc, process_count = _chunks(net, arrays)
        score = net.score_  # lazy: read once
        meta = {
            "iteration": int(net.iteration),
            "epoch": int(net.epoch),
            "score": float(score) if score == score else None,
            "process_count": process_count,
            "generation": gen,
        }
        if self.partitioner is not None:
            # the layout identity: a restore under another one is refused
            # unless it asks to reshard
            meta["mesh_layout"] = self.partitioner.describe()
        if iterator is not None and hasattr(iterator, "state"):
            meta["iterator"] = iterator.state()

        def write():
            t0 = time.perf_counter()
            faults.fault_point("ckpt_write", meta["iteration"])  # chaos:
            # slow_ckpt_io=<seconds> / enospc@iter=<n>
            # the save id is stamped into the shard AND the meta file;
            # verification refuses mismatches, so no kill sequence can pair
            # new weights with stale counters
            blob = {"__save_id__": np.asarray(meta["iteration"], np.int64)}
            for path, (idx, shape, a) in chunks.items():
                key = f"{path}|0"
                blob[key] = a
                blob[f"{key}|idx"] = np.asarray(idx, np.int64)
                blob[f"{key}|shape"] = np.asarray(shape, np.int64)
            tmp = os.path.join(ckdir, f"shard_{proc}.npz.tmp")
            final = os.path.join(ckdir, f"shard_{proc}.npz")
            with open(tmp, "wb") as f:
                np.savez(f, **blob)
            # commit boundary 1 — mid-shard (chaos: torn_ckpt@stage=shard):
            # the tmp bytes exist but the rename has not happened
            faults.fault_point("ckpt_shard", meta["iteration"])
            durability.durable_replace(tmp, final, fsync=self.durable)
            # commit boundary 2 — post-shard / pre-manifest
            faults.fault_point("ckpt_manifest", meta["iteration"])
            manifest = _self_checksummed({
                "save_id": meta["iteration"],
                "proc": proc,
                "process_count": process_count,
                "layout": meta.get("mesh_layout"),
                "shard": os.path.basename(final),
                "entries": {k: _array_crc(v) for k, v in blob.items()},
                "nbytes": int(sum(int(v.nbytes) for v in blob.values())),
            })
            durability.durable_write_json(
                os.path.join(ckdir, f"manifest_{proc}.json"), manifest,
                fsync=self.durable)
            if proc == 0:
                self._commit(lineage, ckdir, gen, meta, tag)
            dt = time.perf_counter() - t0
            self._save_hist.observe(dt)
            flight.record("ckpt_save", tag=tag, generation=gen,
                          iteration=meta["iteration"], seconds=round(dt, 4))

        def async_guarded_write():
            try:
                write()
            except BaseException as e:  # captured, re-raised at wait()/save()
                self._failures.inc()
                log.error("async checkpoint write to %s failed: %s", ckdir, e)
                self._error = e

        if self.async_write:
            # non-daemon: a clean interpreter exit drains the write instead
            # of silently discarding a checkpoint save() already returned for
            self._writer = threading.Thread(target=async_guarded_write,
                                            daemon=False)
            self._writer.start()
        else:
            try:
                write()
            except BaseException:
                self._failures.inc()
                raise
        return ckdir

    def _commit(self, lineage: str, ckdir: str, gen: str, meta: dict,
                tag: str) -> None:
        """The second phase: check the manifest, fsync, write the COMMIT
        marker, repoint the pointer, GC. A kill anywhere in here leaves the
        generation either uncommitted (restore quarantines and falls back)
        or fully committed (restore finds it by iteration even if the
        pointer never moved)."""
        t0 = time.perf_counter()
        # a torn leftover of a bigger gang at this iteration may hold shards
        # of ranks this save does not have: they must not be committed into
        # this generation
        expected = int(meta["process_count"])
        for fname in os.listdir(ckdir):
            stale = None
            if fname.startswith("shard_") and fname.endswith(".npz"):
                stale = fname[len("shard_"):-len(".npz")]
            elif fname.startswith("manifest_") and fname.endswith(".json"):
                stale = fname[len("manifest_"):-len(".json")]
            try:
                if stale is not None and int(stale) >= expected:
                    os.unlink(os.path.join(ckdir, fname))
            except (ValueError, OSError):
                continue
        durability.durable_write_json(
            os.path.join(ckdir, _STATE_FILE), _self_checksummed(meta),
            fsync=self.durable)
        self._await_manifests(ckdir, meta)
        if self.durable:
            durability.fsync_dir(ckdir)
        # commit boundary 3 — pre-COMMIT (chaos: torn_ckpt@stage=commit)
        faults.fault_point("ckpt_commit", meta["iteration"])
        durability.durable_write_json(
            os.path.join(ckdir, _COMMIT_FILE),
            {"generation": gen, "iteration": meta["iteration"],
             "process_count": expected,
             "wall": time.time()},  # human-facing timestamp
            fsync=self.durable)
        self._m.commits.inc()
        # commit boundary 4 — pre-pointer-swap (chaos: torn_ckpt@stage=pointer)
        faults.fault_point("ckpt_pointer", meta["iteration"])
        durability.durable_write_bytes(
            os.path.join(lineage, _POINTER_FILE), (gen + "\n").encode(),
            fsync=self.durable)
        flight.record("ckpt_commit", tag=tag, generation=gen,
                      iteration=meta["iteration"], shards=expected,
                      seconds=round(time.perf_counter() - t0, 4))
        self._gc(lineage)
        # post-commit hook (chaos: corrupt_ckpt bit-flips a committed shard)
        faults.fault_point("ckpt_committed", meta["iteration"], path=ckdir)

    def _await_manifests(self, ckdir: str, meta: dict) -> None:
        """Bounded poll until every rank's manifest is present, parses, and
        self-checksums for THIS save. Raising here fails the save (the
        generation stays uncommitted, which restore quarantines)."""
        expected = int(meta["process_count"])
        deadline = time.monotonic() + self.commit_timeout
        while True:
            missing = [p for p in range(expected) if not _manifest_matches_save(
                _read_checksummed_json(os.path.join(ckdir, f"manifest_{p}.json"))[0], meta)]
            if not missing:
                return
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"checkpoint commit timed out after {self.commit_timeout}s waiting for "
                    f"rank manifest(s) {missing} in {ckdir} — generation stays uncommitted; "
                    "restore will quarantine it")
            time.sleep(0.05)

    def _gc(self, lineage: str) -> None:
        """Keep-last-K: retire committed generations beyond ``keep_last``
        and uncommitted leftovers older than the newest committed one. The
        newest committed generation is always inside the kept tail."""
        gens = _list_generations(lineage)
        committed = [(it, n) for it, n in gens
                     if _is_committed(os.path.join(lineage, n))]
        if not committed:
            return
        newest = committed[-1]
        doomed = [(n, "committed") for _, n in committed[:-self.keep_last]]
        doomed += [(n, "stale") for it, n in gens
                   if (it, n) not in committed and (it, n) < newest]
        for name, kind in doomed:
            try:
                shutil.rmtree(os.path.join(lineage, name))
            except OSError as e:
                log.warning("checkpoint GC could not retire %s: %s", name, e)
                continue
            self._m.gc_retired.labels(kind).inc()

    def wait(self):
        """Block until the in-flight async write (if any) is durable. If the
        write failed on the background thread, re-raise its exception here —
        callers must not believe a checkpoint exists when it doesn't."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore

    def restore(self, net, iterator=None, tag: str = "latest",
                reshard: Optional[bool] = None) -> bool:
        """Load the newest VERIFIABLE checkpoint of the lineage into the net
        (+ counters, + iterator position). Returns False when the lineage is
        genuinely empty (nothing was ever committed). The walk is
        newest-committed-first: a generation failing verification is
        quarantined and the walk falls back to the next older one, raising
        :class:`CheckpointVerifyError` only when a commit demonstrably
        existed and nothing verifies. Restore is TRANSACTIONAL: any failure
        before success leaves parameters, updater state, BN statistics,
        ``net.iteration`` and the iterator position bit-identical.

        Under a ``partitioner`` each rank loads its blocks from the saved
        chunks (module docstring); a checkpoint written under another
        layout needs ``reshard`` (default: the constructor's), else the
        restore raises, naming both layouts."""
        do_reshard = self.reshard if reshard is None else reshard
        self.wait()  # never read past our own in-flight async write
        lineage = os.path.join(self.dir, tag)
        if not os.path.isdir(lineage):
            return False
        gens = _list_generations(lineage)
        # a pre-lineage flat checkpoint may coexist with generations: they
        # are NEWER by construction, so it is the LAST fallback
        legacy = os.path.exists(os.path.join(lineage, _STATE_FILE))
        if not gens:
            if legacy:
                return self._load_generation(net, iterator, tag, lineage, generation=None,
                                             reshard=do_reshard)
            if any(f.startswith("shard_") and f.endswith(".npz")
                   for f in os.listdir(lineage)):
                # a legacy dir torn between the shard and metadata writes
                self._m.verify_failures.labels("meta_missing").inc()
                raise CheckpointVerifyError(
                    f"{lineage} holds shard files but no {_STATE_FILE} — a "
                    "legacy checkpoint torn by a kill between the shard and "
                    "metadata writes; refusing to silently train from "
                    "scratch over it")
            quarantined = sorted(
                n for n in os.listdir(lineage) if CORRUPT_SUFFIX in n)
            if _read_pointer(lineage) is not None or any(
                    os.path.exists(os.path.join(lineage, n, _COMMIT_FILE))
                    for n in quarantined):
                # the pointer, or a COMMIT marker inside the quarantined
                # evidence, proves a commit once existed: the all-corrupt
                # verdict must be STICKY across restarts
                raise CheckpointVerifyError(
                    f"{lineage} holds no restorable generation but a "
                    f"committed checkpoint demonstrably existed "
                    f"(quarantined evidence: {quarantined}) — refusing to "
                    "silently train from scratch over lost progress; clear "
                    "the lineage dir to deliberately start fresh")
            return False  # genuinely empty
        committed = [(it, n) for it, n in gens
                     if _is_committed(os.path.join(lineage, n))]
        had_commit = bool(committed) or _read_pointer(lineage) is not None
        newest_committed = committed[-1] if committed else (-1, "")
        # torn saves at-or-beyond the committed tip: quarantine them (keeps
        # the evidence and frees the gen name for the next save)
        for it, name in gens:
            if (it, name) not in committed and (it, name) > newest_committed:
                self._m.verify_failures.labels("uncommitted").inc()
                self._quarantine(lineage, name, "uncommitted", tag)
        tried: List[Tuple[str, str]] = []
        newest_name = committed[-1][1] if committed else None
        for it, name in reversed(committed):
            gendir = os.path.join(lineage, name)
            ok, reason, meta = _verify_generation(gendir, deep=True)
            if not ok:
                tried.append((name, reason))
                self._m.verify_failures.labels(reason).inc()
                self._quarantine(lineage, name, reason, tag)
                continue
            if name != newest_name:
                self._m.fallbacks.inc()
                flight.record("ckpt_fallback", tag=tag,
                              from_generation=newest_name,
                              to_generation=name,
                              failures=[{"generation": n, "reason": r}
                                        for n, r in tried])
                log.warning(
                    "checkpoint fallback: %s failed verification (%s); "
                    "restoring %s instead", newest_name,
                    ", ".join(f"{n}: {r}" for n, r in tried), name)
            return self._load_generation(net, iterator, tag, gendir,
                                         generation=name, meta=meta, reshard=do_reshard)
        if legacy:
            # every generation failed (or none committed) but a pre-lineage
            # flat checkpoint survives underneath: the deepest fallback
            self._m.fallbacks.inc()
            flight.record("ckpt_fallback", tag=tag,
                          from_generation=newest_name,
                          to_generation="(legacy)",
                          failures=[{"generation": n, "reason": r}
                                    for n, r in tried])
            log.warning("no generation in %s verifies — falling back to the "
                        "pre-lineage flat checkpoint", lineage)
            return self._load_generation(net, iterator, tag, lineage, generation=None,
                                         reshard=do_reshard)
        if had_commit:
            raise CheckpointVerifyError(
                f"no generation in {lineage} verifies (tried: "
                f"{['%s: %s' % t for t in tried]}) — a committed checkpoint "
                "existed but nothing restorable remains; the failing "
                "generations were quarantined")
        log.warning("lineage %s holds only torn (never-committed) "
                    "generations — quarantined; treating as no checkpoint",
                    lineage)
        return False

    def _quarantine(self, lineage: str, name: str, reason: str, tag: str) -> None:
        """Rename a failing generation to ``*.corrupt`` — evidence for the
        postmortem, poison removed from the restore path. A sharded
        lineage's generation is renamed by rank 0 of the partitioner's mesh
        only (every rank reaches the same verdict from the same bytes)."""
        if self.partitioner is not None and self.partitioner.mesh.rank != 0:
            return
        target = _rename_corrupt(os.path.join(lineage, name))
        if target is None:
            return
        if self.durable:
            durability.fsync_dir(lineage)
        self._m.quarantined.inc()
        flight.record("ckpt_quarantine", tag=tag, generation=name,
                      reason=reason, renamed_to=os.path.basename(target))
        log.error("checkpoint generation %s quarantined -> %s (%s)",
                  name, os.path.basename(target), reason)

    def _load_generation(self, net, iterator, tag: str, ckdir: str,
                         generation: Optional[str], meta: Optional[dict] = None,
                         reshard: bool = False) -> bool:
        """Load one (already-verified) generation — or a legacy flat dir —
        into the net. Every array is read, assembled (or, under a
        partitioner, cut into this rank's blocks) and checked against the
        net before the first tensor is written."""
        from .net_state import load

        state_path = os.path.join(ckdir, _STATE_FILE)
        if meta is None:
            if not os.path.exists(state_path):
                return False
            with open(state_path) as f:
                meta = json.load(f)
        saved = meta.get("mesh_layout")
        want = self.partitioner.describe() if self.partitioner is not None else None
        if reshard and saved is None and want is None:
            raise ValueError(f"restore(reshard=True) of {ckdir}: neither the checkpoint nor "
                             "this checkpointer names a mesh layout, so there is nothing to "
                             "reshard between (pass a partitioner)")
        resharding = self.partitioner is not None and saved is not None and saved != want
        if resharding and not reshard:
            raise ValueError(
                f"mesh layout mismatch restoring {ckdir}: checkpoint was written with layout "
                f"{_fmt_layout(saved)} but the restore requested {_fmt_layout(want)} — shards "
                "do not line up; restore with a matching SpecLayout/Partitioner, or pass "
                "reshard=True to redistribute the saved chunks onto the new layout")
        if saved is not None and self.partitioner is None:
            log.info("restoring %s, written on the mesh layout %s: its chunks are assembled "
                     "into whole arrays on the host", ckdir, saved)
        shard_files = sorted(f for f in os.listdir(ckdir)
                             if f.startswith("shard_") and f.endswith(".npz"))
        expected = int(meta.get("process_count", 1))
        if len(shard_files) < expected:
            raise ValueError(
                f"partial checkpoint in {ckdir}: {len(shard_files)} shard "
                f"files for a {expected}-process save — a process was likely "
                "killed mid-write; refusing to restore silently-zeroed weights")
        t0 = time.perf_counter()
        if self.partitioner is None:
            load(net, _assemble(ckdir, meta, shard_files), source=ckdir)
        else:
            nbytes = _restore_blocks(net, self.partitioner, ckdir, meta, shard_files)
            if resharding:
                _note_reshard(saved, want, nbytes, time.perf_counter() - t0, tag)
        net.iteration = meta["iteration"]
        net.epoch = meta["epoch"]
        if iterator is not None and "iterator" in meta and \
                hasattr(iterator, "set_state"):
            iterator.set_state(meta["iterator"])
        flight.record("ckpt_restore", tag=tag, generation=generation,
                      iteration=meta["iteration"], epoch=meta["epoch"])
        return True

    def committed_generation(self, tag: str = "latest") -> Optional[str]:
        """Absolute path of the newest committed generation dir, or None.
        (The ``LATEST`` pointer normally agrees; a kill between COMMIT and
        pointer swap leaves it one behind, and iteration order wins.)"""
        lineage = os.path.join(self.dir, tag)
        committed = [(it, n) for it, n in _list_generations(lineage)
                     if _is_committed(os.path.join(lineage, n))]
        if not committed:
            return None
        return os.path.join(lineage, committed[-1][1])


def _fmt_layout(layout) -> str:
    """Human-readable layout identity for mismatch errors."""
    if not layout:
        return "replicated (no mesh layout)"
    ax = layout.get("axes", {})
    out = f"data={ax.get('data')} x fsdp={ax.get('fsdp')} x tp={ax.get('tp')}"
    if ax.get("pipe", 1) != 1:
        out = f"pipe={ax.get('pipe')} x " + out
    return out


def _chunks(net, arrays: Dict[str, np.ndarray]):
    """(chunks {path: (index ranges, whole shape, array)}, proc,
    process_count) of one save: a partitioned network's blocks that are the
    first copy on the mesh, under its rank; else every whole array under
    rank 0 — of one process, or of the process group, whose ranks hold
    replicas of the network (a data-parallel gang: rank 0 writes the
    arrays, every other rank an empty shard, and rank 0 commits once every
    manifest is in, as the JAX package's replicated save does)."""
    part = getattr(net, "_partition", None)
    if part is None:
        whole = {p: ([[0, n] for n in a.shape], a.shape, a) for p, a in arrays.items()}
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return whole, 0, 1
        rank = dist.get_rank()
        return (whole if rank == 0 else {}), rank, dist.get_world_size()
    from ..parallel.sharding import P, is_replica_zero, shard_slices

    mesh = part.mesh
    out = {}
    for path, a in arrays.items():
        top, rest = path.split("/", 1)
        if top == "bn":
            spec, shape = P(), a.shape
        else:
            layer, name = rest.split("/")[-2:]
            spec, shape = part.spec(layer, name), part.shapes[(layer, name)]
        if is_replica_zero(spec, mesh):
            idx = [[s.start, s.stop] for s in shard_slices(shape, spec, mesh)]
            out[path] = (idx, tuple(shape), a)
    if mesh.n_devices == 1:
        return out, 0, 1
    return out, mesh.rank, mesh.n_devices


def _fill_from_chunks(index, chunks, path: str, stats: dict) -> np.ndarray:
    """One block's data, copied from the overlapping saved chunks
    (``(saved index ranges, npz, key)`` each). The saved chunks need not
    line up with the block (a restore under another layout); coverage is
    verified cell for cell: the first-copy filter on save makes the chunks
    a disjoint tiling, so the copied cells equal the block's iff every cell
    was written exactly once."""
    out = None
    copied = 0
    for saved_idx, npz, key in chunks:
        ov = [(max(t.start, int(lo)), min(t.stop, int(hi)))
              for t, (lo, hi) in zip(index, saved_idx)]
        if any(lo >= hi for lo, hi in ov):
            continue
        data = npz[key]
        if out is None:
            out = np.zeros([t.stop - t.start for t in index], data.dtype)
        dst = tuple(slice(lo - t.start, hi - t.start) for (lo, hi), t in zip(ov, index))
        src = tuple(slice(lo - int(slo), hi - int(slo)) for (lo, hi), (slo, _) in
                    zip(ov, saved_idx))
        out[dst] = data[src]
        copied += int(np.prod([hi - lo for lo, hi in ov]))
    size = int(np.prod([t.stop - t.start for t in index])) if index else 1
    if out is None or copied != size:
        raise ValueError(
            f"saved chunks cover {copied}/{size} cells of block {list(index)} of {path!r} — "
            "the checkpoint does not tile this leaf (torn, overlapping, or foreign-layout "
            "write)")
    stats["bytes"] += int(out.nbytes)
    return out


def _restore_blocks(net, partitioner, ckdir: str, meta: dict, shard_files) -> int:
    """Load this rank's blocks of every array of ``net``'s state under
    ``partitioner`` from a generation's chunks (whatever layout wrote them),
    partitioning the network first if it is not yet. Everything is read and
    checked before the network changes. Returns the bytes copied."""
    from ..parallel.partition import param_role_tree, partition_with_specs, whole_params
    from ..parallel.sharding import P, shard_slices
    from .net_state import _targets, from_numpy

    specs = partitioner.spec_tree(whole_params(net), param_role_tree(net))
    shapes = {f"params/{layer}/{name}": tuple(leaf.shape)
              for layer, names in whole_params(net).items() for name, leaf in names.items()}
    stats = {"bytes": 0}
    index: Dict[str, list] = {}
    handles = []
    try:
        for fname in shard_files:
            npz = np.load(os.path.join(ckdir, fname))
            handles.append(npz)
            sid = int(npz["__save_id__"]) if "__save_id__" in npz.files else None
            if sid is not None and sid != int(meta["iteration"]):
                raise ValueError(f"checkpoint {ckdir}/{fname} save id {sid} does not match "
                                 f"metadata iteration {meta['iteration']} — torn checkpoint")
            for key in npz.files:
                if "|" not in key or key.endswith("|idx") or key.endswith("|shape"):
                    continue
                path = key.rsplit("|", 1)[0]
                index.setdefault(path, []).append(
                    (np.asarray(npz[f"{key}|idx"]), tuple(int(n) for n in npz[f"{key}|shape"]),
                     npz, key))
        targets = _targets(net)
        has = {top for top in ("updater", "bn") if any(p.startswith(top + "/") for p in index)}
        blocks = {}
        for path, t in targets.items():
            top, rest = path.split("/", 1)
            if top != "params" and top not in has:
                continue  # a stateless updater's checkpoint keeps the net's state
            if path not in index:
                raise ValueError(f"checkpoint {ckdir} is missing chunks for {path!r}, which "
                                 "the network declares — model drift between save and "
                                 "restore; resharding cannot invent them")
            layer, name = rest.split("/")[-2:]
            whole = tuple(t.shape) if top == "bn" else shapes[f"params/{layer}/{name}"]
            saved_shape = index[path][0][1]
            if saved_shape != whole:
                raise ValueError(f"param-shape mismatch restoring {ckdir}: {path!r} was saved "
                                 f"as {saved_shape} but the network declares {whole} — "
                                 "resharding cannot reconcile a shape change")
            spec = P() if top == "bn" else specs[layer][name]
            got = _fill_from_chunks(shard_slices(whole, spec, partitioner.mesh),
                                    [(i, z, k) for i, _, z, k in index[path]], path, stats)
            src = from_numpy(got)
            if src.dtype != t.dtype:
                raise ValueError(f"{ckdir}: {path!r} was saved as {src.dtype} but the network "
                                 f"holds {t.dtype}; a checkpoint is restored into a network "
                                 "of its own dtype, never converted")
            blocks[path] = src
        extra = sorted(p for p in index if p not in targets)
        if extra:
            raise ValueError(f"checkpoint {ckdir} holds state the network does not declare: "
                             f"{extra[:8]} — model drift between save and restore")
    finally:
        for npz in handles:
            npz.close()
    import torch

    if getattr(net, "_partition", None) is None:
        partition_with_specs(net, partitioner.mesh, specs)
    elif net._partition.specs != specs:
        raise ValueError("the network is partitioned under another layout than the "
                         "checkpointer's partitioner")
    targets = _targets(net)
    with torch.no_grad():
        for path, src in blocks.items():
            if tuple(src.shape) != tuple(targets[path].shape):
                raise ValueError(f"{path!r}: block {tuple(src.shape)} != the network's "
                                 f"{tuple(targets[path].shape)}")
        for path, src in blocks.items():
            targets[path].copy_(src)
    return stats["bytes"]


def _note_reshard(saved, want, nbytes: int, seconds: float, tag: str) -> None:
    """A cross-layout restore is priced, not silent: the reshard counter and
    histogram and a flight event naming both layouts."""
    from ..monitoring.partition import elastic_metrics

    m = elastic_metrics()
    m.reshard_bytes.inc(nbytes)
    m.reshard_seconds.observe(seconds)
    flight.record("ckpt_reshard", tag=tag, from_layout=_fmt_layout(saved),
                  to_layout=_fmt_layout(want), bytes=int(nbytes), seconds=round(seconds, 4))


def _assemble(ckdir: str, meta: dict, shard_files) -> Dict[str, np.ndarray]:
    """{path: whole array} from a generation's shard files: each saved chunk
    is copied into its index range of the global array (one chunk per leaf
    for a replicated save; several for a JAX gang's)."""
    assembled: Dict[str, np.ndarray] = {}
    for fname in shard_files:
        with np.load(os.path.join(ckdir, fname)) as npz:
            sid = int(npz["__save_id__"]) if "__save_id__" in npz.files else None
            if sid is not None and sid != int(meta["iteration"]):
                raise ValueError(
                    f"checkpoint {ckdir}/{fname} save id {sid} does not "
                    f"match metadata iteration {meta['iteration']} — torn "
                    "checkpoint (kill between shard and metadata writes)")
            for key in npz.files:
                if "|" not in key or key.endswith("|idx") or key.endswith("|shape"):
                    continue
                path = key.rsplit("|", 1)[0]
                data = npz[key]
                if path not in assembled:
                    shape = tuple(int(n) for n in npz[f"{key}|shape"])
                    assembled[path] = np.zeros(shape, data.dtype)
                sl = tuple(slice(int(a), int(b)) for a, b in npz[f"{key}|idx"])
                assembled[path][sl] = data
    return assembled


class PreemptionHandler:
    """SIGTERM/SIGINT → checkpoint-before-death (the cloud preemption
    contract).

    Usage: ``PreemptionHandler(ckpt, net, iterator).install()``; on a signal
    it saves synchronously under ``tag="preempt"`` (the snapshot waits for
    the card), then re-raises the default behaviour (the process dies by
    the signal) unless ``swallow=True`` (tests). The handler runs on the
    main thread between two bytecodes, so the save sees the state of
    whatever the main thread had finished: deliver the signal at a step
    boundary (as a scheduler's grace period does) for a resumable state."""

    def __init__(self, checkpointer: TrainingCheckpointer, net, iterator=None,
                 signals=(signal.SIGTERM,), swallow: bool = False):
        self.ck = checkpointer
        self.net = net
        self.iterator = iterator
        self.signals = signals
        self.swallow = swallow
        self.fired = False
        self._prev: Dict[int, Any] = {}

    def install(self) -> "PreemptionHandler":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def _handle(self, signum, frame):
        self.fired = True
        was_async = self.ck.async_write
        self.ck.async_write = False  # the process is dying: write NOW
        try:
            self.ck.save(self.net, self.iterator, tag="preempt")
        finally:
            self.ck.async_write = was_async
        if not self.swallow:
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
