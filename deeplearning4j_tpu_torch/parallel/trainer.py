"""Distributed trainers: data-parallel over processes, one device each.

Counterpart of ``deeplearning4j_tpu/parallel/trainer.py``:

- ``ParallelTrainer`` — synchronous data parallelism over the data mesh
  (``parallel.mesh``: the ranks of the process group that
  ``launcher.initialize`` set up, or this one process). Every rank feeds the
  same GLOBAL batch and trains on its rows; the network's own step runs
  under a :class:`~..common.data_parallel.DataParallelContext`, which makes
  it one logical step over the ranks: gradients and loss reduced across the
  group, BatchNormalization's moments and dropout's masks the global
  batch's. The JAX package gets the same from GSPMD over a mesh of devices.
- ``MultiProcessTrainer`` — the same step, but every rank feeds only its
  LOCAL shard of the global batch (the SPMD input pipeline).
- ``ParameterAveragingTrainingMaster`` (DL4J's S2) — in-process replicas
  (``net.clone()``) that fit in turn and average parameters and updater
  state every ``averaging_frequency`` batches.
- ``SharedTrainingMaster`` (S3) — synchronous data parallelism, as in the
  JAX package; the threshold codecs live in ``parallel.compression``.

Each step fires the gang-supervision hooks (heartbeat, flight events, the
``train_step`` fault site and ``loss_spike`` poisoning) and feeds the
metric families of the JAX trainers (``tdl_parallel_step_seconds``,
``tdl_collective_bytes_total``, ``tdl_parallel_devices``,
``tdl_step_wall_seconds``; ``tdl_step_phase_seconds`` by phase) into the
port's registry under the same names and labels.

Sharded training: ``mesh_layout=SpecLayout(data, fsdp, tp)`` (or a
``Partitioner``) keeps on each rank its blocks of the parameters and the
updater state (``parallel.partition``), and ``sharding_rules=`` (a
``parallel.sharding.ShardingRules``, ``ParallelTrainer`` only, as in the JAX
package) does the same by per-parameter rules over a ``model`` axis. The
step is still one logical step on the global batch: rows split over the
data axis (and over ``fsdp`` under a layout, where the JAX package
replicates them: the numbers are the same), each parameter gathered whole
for the forward, the whole gradients reduced over the ranks of distinct
rows, and the updater applied to the blocks. Whatever reads a whole
layer's norm sees the whole layer: every ``GradientNormalization`` mode
(``ClipElementWiseAbsoluteValue``, ``ClipL2PerLayer``,
``ClipL2PerParamType``, ``RenormalizeL2PerLayer``) runs on the whole reduced
gradients, and the weight constraints on the gathered parameters; the
port's updaters are elementwise (none has a trust ratio), so updating the
blocks is exact. ``checkpointer()`` carries the partitioner into
``serde.checkpoint``. A layout with a ``pipe`` axis is refused here: only
``parallel.pipeline.PipelineParallelTrainer`` runs the microbatch schedule
it implies.

Input: ``fit(prefetch=K)`` stages the next K batches on the card while the
step runs (``prefetch()``: a ``DevicePrefetchIterator`` over
``batch_sharding()``, which copies only this rank's rows of a batch);
``sharded_etl(spec)`` gives this rank's slice of the multi-process ETL
service (``data.etl_service``) behind that prefetcher; ``bucketing=``
pads ragged batches to a bucket that the data group divides.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..common import faults
from ..common.data_parallel import DataParallelContext
from ..data.dataset import DataSet, MultiDataSet
from ..monitoring import aggregate, flight, heartbeat
from ..monitoring.registry import get_registry
from ..monitoring.trace import StepPhaseRecorder, step_phase_histogram
from .mesh import AXIS_DATA, Mesh, build_mesh


def _trainer_metrics():
    """Shared metric families for every trainer class (get-or-create)."""
    r = get_registry()
    return (
        r.histogram("tdl_parallel_step_seconds",
                    "Host-observed wall time of one distributed fit-batch "
                    "dispatch (async: excludes device completion)",
                    labels=("trainer",)),
        r.counter("tdl_collective_bytes_total",
                  "Logical payload bytes moved by training collectives",
                  labels=("trainer", "kind")),
        r.gauge("tdl_parallel_devices", "Devices participating in the mesh",
                labels=("trainer",)),
        r.histogram("tdl_step_wall_seconds",
                    "Iteration-to-iteration wall time, including everything "
                    "between steps (checkpoint IO, input stalls, barriers) — "
                    "the per-rank signal the aggregated /metrics derives "
                    "straggler skew from",
                    labels=("trainer",)),
    )


class ParallelTrainer:
    """Synchronous data-parallel trainer over the data mesh.

    Parameters, updater and BN state are replicated: every rank holds the
    same copy (networks built from the same seed, or restored from one
    checkpoint) and applies the same reduced update. Each global batch is
    split on its leading axis; a batch that does not divide by the mesh's
    size trains its divisible head data-parallel and its remainder as one
    ordinary step on every rank (the same inputs, so the replicas stay
    equal), as the JAX trainer does."""

    #: whether this trainer runs the microbatch schedule a SpecLayout pipe
    #: axis implies; parallel.pipeline.PipelineParallelTrainer flips it
    _supports_pipe = False

    def __init__(self, net, mesh: Optional[Mesh] = None, data_axis: str = AXIS_DATA,
                 sharding_rules=None, mesh_layout=None, bucketing=None):
        from ..common import compile_cache

        compile_cache.maybe_enable_from_env()
        self.net = net
        if bucketing is not None:
            net.set_bucketing(bucketing)
        if mesh_layout is not None and sharding_rules is not None:
            raise ValueError("pass mesh_layout OR sharding_rules, not both")
        self.partitioner = None
        self.partition_report = None
        self.sharding_rules = sharding_rules
        rows = (data_axis,)
        if mesh_layout is not None:
            from .partition import Partitioner, SpecLayout

            layout = mesh_layout if isinstance(mesh_layout, SpecLayout) else mesh_layout.layout
            if layout.pipe != 1 and not self._supports_pipe:
                # a pipe axis treated as more data or fsdp parallelism would
                # train wrong: only the pipeline trainer runs its schedule
                raise ValueError(
                    f"mesh_layout has a pipe axis (pipe={layout.pipe}) but "
                    f"{type(self).__name__} runs no pipeline schedule — use "
                    "parallel.pipeline.PipelineParallelTrainer")
            if isinstance(mesh_layout, SpecLayout):
                mesh_layout = Partitioner(mesh_layout, mesh=mesh)
            elif mesh is not None and mesh is not mesh_layout.mesh:
                # a pre-built Partitioner owns its mesh
                raise ValueError("mesh conflicts with mesh_layout's Partitioner mesh — pass "
                                 "the mesh to Partitioner(...), or pass a SpecLayout")
            mesh = mesh_layout.mesh
            data_axis = mesh_layout.layout.data_axis
            rows = (data_axis, mesh_layout.layout.fsdp_axis)
            self.partitioner = mesh_layout
        self.mesh = mesh if mesh is not None else build_mesh(**{data_axis: -1})
        if data_axis not in self.mesh.shape:
            raise ValueError(f"data_axis {data_axis!r} is not an axis of the mesh "
                             f"{self.mesh.shape}")
        self.data_axis = data_axis
        # the ranks that compute distinct rows of the global batch
        self._rows = rows
        self._ndata = self.mesh.axis_size(rows)
        self._rank = self.mesh.axis_index(rows)
        (self._step_hist, self._coll_bytes, devices_gauge,
         self._step_wall) = _trainer_metrics()
        self._trainer_label = type(self).__name__
        devices_gauge.labels(self._trainer_label).set(self.mesh.n_devices)
        self._grad_bytes: Optional[int] = None
        self._phases = StepPhaseRecorder()
        self._context = DataParallelContext(self.mesh.group(rows), self._rank, self._ndata,
                                            self._phases)
        self._last_step_entry: Optional[float] = None

    # -- placement ----------------------------------------------------------

    def _place_net(self):
        """Partition the network once (a network restored from a sharded
        checkpoint comes partitioned already)."""
        n = self.net
        if self.partitioner is None and self.sharding_rules is None:
            return
        if getattr(n, "_partition", None) is None:
            if self.partitioner is not None:
                self.partition_report = self.partitioner.partition_net(n)
            else:
                from .partition import param_tree, partition_with_specs

                # the rules' specs, a dim its axis does not divide left whole
                _, specs = self.sharding_rules.shard_tree(param_tree(n), self.mesh)
                partition_with_specs(n, self.mesh, specs)
        self._context.shards = n._partition

    # -- checkpointing ------------------------------------------------------

    def checkpointer(self, directory: str, **kw):
        """A :class:`~..serde.checkpoint.TrainingCheckpointer` carrying this
        trainer's partitioner: each rank saves its blocks, the layout is
        stamped in the manifest, and a restore under another layout needs
        ``reshard=True``."""
        from ..serde.checkpoint import TrainingCheckpointer

        kw.setdefault("partitioner", self.partitioner)
        return TrainingCheckpointer(directory, **kw)

    # -- input staging ------------------------------------------------------

    def _stage(self, x, dtype=None):
        """A minibatch array as a tensor on the network's device."""
        if x is None:
            return None
        with self._phases.phase("h2d"):
            return self.net._put(x, dtype)

    def _input_dtypes(self, n_inputs: int):
        """The staging dtype of each features array: the network's dtype,
        or the wire dtype (None) of an input with an on-device ingest."""
        n = self.net
        names = getattr(n.conf, "network_inputs", None)
        if names is None:
            return [n._features_dtype()] * n_inputs
        return [n._wire_dtype(name) for name in names[:n_inputs]]

    def _staged(self, ds):
        if isinstance(ds, MultiDataSet):  # a ComputationGraph's several inputs and outputs
            many = lambda xs: None if xs is None else [self._stage(x) for x in xs]  # noqa: E731
            feats = [self._stage(x, d) for x, d in
                     zip(ds.features, self._input_dtypes(len(ds.features)))]
            return MultiDataSet(feats, many(ds.labels), many(ds.features_masks),
                                many(ds.labels_masks))
        return DataSet(self._stage(ds.features, self._input_dtypes(1)[0]),
                       self._stage(ds.labels), self._stage(ds.features_mask),
                       self._stage(ds.labels_mask))

    def batch_sharding(self) -> "BatchSharding":
        """How a global batch is placed: its rows split over the ranks of
        distinct rows, this rank's part on its device. Hand it to a
        :class:`~..data.iterators.DevicePrefetchIterator` and each rank
        copies only its rows (the one-shot placement); the fit loop's
        staging then does nothing."""
        return BatchSharding(self._rank, self._ndata, self.net.device)

    def prefetch(self, iterator, buffer_size: int = 2):
        """Wrap ``iterator`` so that the next ``buffer_size`` batches are
        copied to the card (this rank's rows) while the current step runs.
        Under bucketing a batch is staged whole: the trainer pads the
        global batch before it splits it."""
        from ..data.iterators import DevicePrefetchIterator

        sharding = None if getattr(self.net, "_bucketing", None) is not None \
            else self.batch_sharding()
        return DevicePrefetchIterator(iterator, buffer_size=buffer_size, sharding=sharding,
                                      device=self.net.device)

    # -- sharded ETL --------------------------------------------------------

    def _etl_rank_world(self):
        """(rank, world size) for per-rank input sharding: every rank of a
        ParallelTrainer feeds the same global batches, so it reads the
        whole stream; MultiProcessTrainer overrides."""
        return 0, 1

    #: whether this trainer's ``prefetch()`` buffers HOST views across
    #: ``base.next()`` calls. DevicePrefetchIterator copies each batch to the
    #: card before it asks for the next, so the ring's view is done with
    #: when its slot is released: zero-copy is safe. MultiProcessTrainer's
    #: AsyncDataSetIterator queues the raw views, which a worker could
    #: overwrite in place.
    _prefetch_buffers_host_views = False

    def sharded_etl(self, spec, num_workers=None, ring_slots=None, prefetch: int = 2):
        """This rank's slice of a multi-process ETL pipeline: the spec
        re-ranked to this trainer's (rank, world size), so each gang member's
        workers decode only its batches, the same ones across restarts, and
        wrapped in the trainer's prefetcher (``prefetch=0`` gives the bare
        :class:`~..data.etl_service.EtlDataSetIterator`, e.g. to
        ``set_state`` before fitting)."""
        from ..data.etl_service import EtlDataSetIterator

        spec = spec.for_rank(*self._etl_rank_world())
        zero_copy = not (prefetch and self._prefetch_buffers_host_views)
        it = EtlDataSetIterator(spec, num_workers=num_workers, ring_slots=ring_slots,
                                zero_copy=zero_copy)
        return self.prefetch(it, buffer_size=prefetch) if prefetch else it

    # -- bucketing ----------------------------------------------------------

    def _bucket_multiple(self) -> int:
        """What the bucket must divide by: the ranks of distinct rows (every
        rank feeds the whole global batch); MultiProcessTrainer's ranks feed
        their local shards, so there it is 1."""
        return self._ndata

    def _bucket_for_mesh(self, ds):
        """``ds`` padded to the network's bucket spec with the data group's
        size folded into the bucket multiple, so a bucketed batch always
        divides and the remainder step stays dead. Returns ``(ds,
        true_examples or None)``."""
        spec = getattr(self.net, "_bucketing", None)
        if spec is None or getattr(ds, "global_examples", None) is not None:
            return ds, None
        import math
        from dataclasses import replace

        from ..common.bucketing import pad_dataset, pad_multidataset

        multiple = self._bucket_multiple()
        if spec.batch_multiple % multiple:
            spec = replace(spec, batch_multiple=math.lcm(spec.batch_multiple, multiple))
        if isinstance(ds, MultiDataSet):
            return pad_multidataset(ds, spec)
        return pad_dataset(ds, spec)

    # -- fit ----------------------------------------------------------------

    def fit(self, iterator, epochs: int = 1, prefetch: int = 0):
        """Fit ``epochs`` passes over ``iterator`` (DataSets of global
        batches; local shards for :class:`MultiProcessTrainer`).
        ``prefetch=K`` overlaps the ETL and the copies of the next K batches
        with the step (0: staged synchronously)."""
        if prefetch:
            iterator = self.prefetch(iterator, buffer_size=prefetch)
        try:
            for _ in range(epochs):
                batches = iter(iterator)
                while True:
                    # pulling the next batch is the step's "input" phase
                    with self._phases.phase("input"):
                        try:
                            ds = next(batches)
                        except StopIteration:
                            break
                    self._fit_batch(ds)
                # the exhausting next() timed an input slice of no step
                self._phases.discard()
                self.net.epoch += 1
        finally:
            # join a prefetching worker even when a step raises (and free a
            # restartable ETL base's processes)
            from ..data.iterators import AsyncDataSetIterator

            if isinstance(iterator, AsyncDataSetIterator):
                iterator.close()
            aggregate.maybe_spool(force=True)
            flight.flush()
        return self.net

    def _fit_batch(self, ds: DataSet):
        ds, self._bucketed_true_examples = self._bucket_for_mesh(ds)
        b = _global_examples(ds)
        rem = b % self._ndata
        if rem and (self.partitioner is not None or self.sharding_rules is not None):
            raise ValueError(f"a global batch of {b} rows over {self._ndata} ranks of "
                             f"distinct rows ({self._rows}): a sharded network has no "
                             "replicated remainder step")
        if rem:
            # trim to divisibility; the remainder goes through a replicated step
            keep = b - rem
            if keep:
                self._fit_batch(_slice_ds(ds, 0, keep))
            self._fit_replicated(_slice_ds(ds, b - rem, b))
            return
        self._fit_core(ds)

    def _fit_replicated(self, ds: DataSet):
        """One ordinary step on every rank (no reduction): the remainder."""
        if isinstance(self.net, _mln()):
            self.net._fit_batch(ds)
        else:
            self.net._fit_batch(*self.net._batch(ds))

    def _fit_core(self, ds: DataSet):
        # gang-supervision hooks (no-ops unless the TDL_HEARTBEAT_DIR /
        # TDL_FAULT_SPEC env contracts are active): heartbeat first, so a
        # fault injected at iteration k is attributed to k, then the flight
        # step_begin, so a victim's last step is on the black box
        self._place_net()
        it = int(self.net.iteration)
        heartbeat.maybe_beat(it)
        flight_on = flight.active()
        if flight_on:
            flight.record("step_begin", iteration=it)
        faults.fault_point("train_step", iteration=it)
        spike = faults.poison_scale("train_step", iteration=it)
        if spike is not None:
            # loss_spike poisoning: the whole parameter tree is scaled, the
            # run keeps training and committing valid checkpoints
            with torch.no_grad():
                for _, _, w in self.net._param_entries():
                    w.mul_(spike)
        now = time.perf_counter()
        if self._last_step_entry is not None:
            self._step_wall.labels(self._trainer_label).observe(now - self._last_step_entry)
        self._last_step_entry = now
        t0 = time.perf_counter()
        with self._phases.phase("compute"):
            self._fit_core_inner(ds)
        self._step_hist.labels(self._trainer_label).observe(time.perf_counter() - t0)
        self._count_collectives()
        self._phases.step_done()
        if flight_on:
            loss = None
            if (it + 1) % flight.loss_every() == 0:
                loss = self.net.score_  # reading the loss waits for the device
            flight.record("step_end", iteration=it, loss=loss)
        aggregate.maybe_spool()

    def _count_collectives(self):
        """Feed ``tdl_collective_bytes_total`` with the step's logical
        payloads."""
        if self._grad_bytes is None:  # whole parameter bytes
            part = getattr(self.net, "_partition", None)
            self._grad_bytes = (part.whole_bytes() if part is not None else
                                sum(w.numel() * w.element_size()
                                    for _, _, w in self.net._param_entries()))
        if self._ndata > 1:
            # logical payload of the step's gradient all-reduce
            self._coll_bytes.labels(self._trainer_label, "grad_allreduce").inc(self._grad_bytes)
        if getattr(self.net, "_partition", None) is not None:
            # the blocks' all-gather into whole tensors
            self._coll_bytes.labels(self._trainer_label, "param_allgather").inc(
                self._grad_bytes)

    def _shard(self, ds: DataSet) -> DataSet:
        """This rank's rows of a global batch, on the device (a batch the
        prefetcher staged through ``batch_sharding()`` holds them already)."""
        if getattr(ds, "global_examples", None) is not None:
            return self._staged(ds)
        b = ds.num_examples() // self._ndata
        return _slice_ds(self._staged(ds), self._rank * b, (self._rank + 1) * b)

    def _fit_core_inner(self, ds: DataSet):
        n = self.net
        local = self._shard(ds)
        # the batch was padded already (a bucket the group divides): the
        # network gets the TRUE count and does not pad again
        true_n = getattr(self, "_bucketed_true_examples", None)
        n._data_parallel = self._context
        try:
            padded = {} if true_n is None else {"true_examples": true_n}
            if isinstance(n, _mln()):
                # the net's own fit paths (tbptt included), one logical step
                n._fit_batch(local, **padded)
            else:  # ComputationGraph
                n._fit_batch(*n._batch(local), **padded)
        finally:
            n._data_parallel = None
        # what this trainer was fed
        n.last_batch_size = true_n if true_n is not None else _global_examples(ds)


def _mln():
    from ..nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork


class MultiProcessTrainer(ParallelTrainer):
    """Data-parallel trainer whose every rank feeds its LOCAL shard: each
    process reads the rows of its data coordinate, batch_global / data
    examples (the standard SPMD input pipeline; ranks that differ only in
    ``fsdp`` or ``tp`` feed the same rows, as JAX's
    ``make_array_from_process_local_data`` asks); the step and its
    reduction are :class:`ParallelTrainer`'s. Local batches must be of one
    size on every rank, as in the JAX package. ``sharding_rules`` raises, as
    in the JAX package: use ``mesh_layout``."""

    def __init__(self, net, mesh: Optional[Mesh] = None, data_axis: str = AXIS_DATA,
                 sharding_rules=None, mesh_layout=None):
        if sharding_rules is not None:
            raise NotImplementedError(
                "MultiProcessTrainer(sharding_rules=): as in the JAX package, a "
                "multi-process gang takes mesh_layout=SpecLayout(...); ParallelTrainer "
                "takes sharding_rules")
        super().__init__(net, mesh, data_axis, mesh_layout=mesh_layout)

    def prefetch(self, iterator, buffer_size: int = 2):
        """Host-staged prefetch, as in the JAX package: each rank feeds its
        local shard, which the step stages itself; overlapping the ETL with
        the step still pays."""
        from ..data.iterators import AsyncDataSetIterator

        return AsyncDataSetIterator(iterator, queue_size=buffer_size)

    # the Async wrapper above queues RAW host batches across base.next()
    # calls: an ETL ring view buffered there could be overwritten in place,
    # so sharded_etl hands out copies
    _prefetch_buffers_host_views = True

    def _etl_rank_world(self):
        # the data coordinate: ranks that differ only in fsdp or tp feed
        # the same rows
        return (self.mesh.axis_index(self.data_axis),
                self.mesh.axis_size(self.data_axis))

    def _bucket_multiple(self) -> int:
        # each rank feeds its local shard to its one device
        return 1

    def _fit_batch(self, ds: DataSet):
        # the remainder fallback cannot cross process boundaries: a rank's
        # local batch must divide by its local device count (one)
        ds, self._bucketed_true_examples = self._bucket_for_mesh(ds)
        b = ds.num_examples()
        if getattr(self.net, "_bucketing", None) is not None:
            _check_lockstep_buckets(b)
        local = self._bucket_multiple()
        if b % local:
            raise ValueError(
                f"multi-process local batch {b} must be divisible by the "
                f"process-local device count {local} (no remainder fallback "
                f"across process boundaries)")
        self._fit_core(ds)

    def _shard(self, ds: DataSet) -> DataSet:
        # the local batch is the data coordinate's rows; under a layout each
        # fsdp rank of that coordinate takes its part of them
        split = self._ndata // self.mesh.axis_size(self.data_axis)
        if split == 1:
            return self._staged(ds)
        b = ds.num_examples()
        if b % split:
            raise ValueError(f"local batch {b} does not split over the {split} ranks of "
                             f"its data coordinate ({self._rows[1:]})")
        i = self.mesh.axis_index(self._rows[1:])
        return _slice_ds(self._staged(ds), i * (b // split), (i + 1) * (b // split))


def _check_lockstep_buckets(b: int) -> None:
    """Every process must pad to the same bucket: per-rank ragged tails that
    straddle a bucket boundary would otherwise hand the reduction buffers of
    different shapes — a hang in the first collective instead of an error.
    One small allgather per batch (only when bucketing is on, so every rank
    takes part) turns that into a ValueError."""
    from .launcher import ProcessCollectives
    from .mesh import device_count

    if device_count() == 1:
        return
    sizes = ProcessCollectives().allgather("lockstep_buckets", int(b))
    if any(s != sizes[0] for s in sizes):
        raise ValueError(
            "bucketed local batch sizes diverged across processes: "
            f"{sizes} — multi-process bucketing requires lockstep "
            "feeds (the same local batch size on every rank each step)")


class BatchSharding:
    """The rows of a global batch that one rank trains on: rank ``r`` of
    ``world`` ranks of distinct rows holds rows ``[r·b/world,
    (r+1)·b/world)`` on ``device`` (``ParallelTrainer.batch_sharding()``,
    read by ``DevicePrefetchIterator``)."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, device

    def divides(self, n: int) -> bool:
        return n % self.world == 0

    def rows(self, a):
        b = int(a.shape[0]) // self.world
        return a[self.rank * b:(self.rank + 1) * b]

    def local(self, ds, placed) -> DataSet:
        """This rank's staged rows of ``ds``, knowing the global count."""
        out = DataSet(*placed)
        out.global_examples = ds.num_examples()
        return out


def _global_examples(ds) -> int:
    g = getattr(ds, "global_examples", None)
    return ds.num_examples() if g is None else g


def _slice_ds(ds, a: int, b: int):
    def s(x):
        return None if x is None else x[a:b]

    if isinstance(ds, MultiDataSet):
        many = lambda xs: None if xs is None else [s(x) for x in xs]  # noqa: E731
        return MultiDataSet(many(ds.features), many(ds.labels), many(ds.features_masks),
                            many(ds.labels_masks))
    return DataSet(s(ds.features), s(ds.labels), s(ds.features_mask), s(ds.labels_mask))


def _mean_tree(trees):
    """The leafwise mean of equal-shaped trees: ``sum(xs) / len(xs)`` of
    tensor leaves, as the JAX master computes it; other leaves from the
    first tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _mean_tree([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_mean_tree([t[i] for t in trees]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return sum(trees) / len(trees)
    return first


def _assign_tree(dst, src):
    """Copy ``src``'s tensor leaves into ``dst``'s, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _assign_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _assign_tree(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


class ParameterAveragingTrainingMaster:
    """DL4J's S2 semantics: W in-process replicas (``net`` and ``W - 1``
    clones on its device) fit ``averaging_frequency`` minibatches each, in
    turn, then parameters (and updater state) are averaged across them."""

    def __init__(self, workers: Optional[int] = None, averaging_frequency: int = 5,
                 average_updater_state: bool = True, batch_size_per_worker: Optional[int] = None):
        from .mesh import device_count

        self.workers = workers or device_count()
        self.averaging_frequency = max(1, averaging_frequency)
        self.average_updater_state = average_updater_state
        self.batch_size_per_worker = batch_size_per_worker
        r = get_registry()
        self._coll_bytes = r.counter(
            "tdl_collective_bytes_total",
            "Logical payload bytes moved by training collectives",
            labels=("trainer", "kind"))
        self._trainer_label = type(self).__name__
        # workers here are logical model replicas, not devices
        r.gauge("tdl_parallel_workers",
                "Logical workers in a parameter-averaging master",
                labels=("trainer",)).labels(self._trainer_label).set(self.workers)
        self._params_bytes: Optional[int] = None

    def fit(self, net, iterator, epochs: int = 1):
        replicas = [net] + [net.clone() for _ in range(self.workers - 1)]
        for _ in range(epochs):
            pending = 0
            batches = iter(iterator)
            while True:
                got = False
                for replica in replicas:
                    try:
                        ds = next(batches)
                    except StopIteration:
                        break
                    replica._fit_batch(ds)
                    got = True
                if not got:
                    break
                pending += 1
                if pending >= self.averaging_frequency:
                    self._average(replicas)
                    pending = 0
            if pending:
                self._average(replicas)
            net.epoch += 1
        return net

    @torch.no_grad()
    def _average(self, replicas):
        t0 = time.perf_counter()
        if self._params_bytes is None:  # parameter sizes are fixed after init
            self._params_bytes = sum(w.numel() * w.element_size()
                                     for _, _, w in replicas[0]._param_entries())
        self._coll_bytes.labels(self._trainer_label, "param_average").inc(
            self._params_bytes * len(replicas))
        entries = [list(r._param_entries()) for r in replicas]
        for column in zip(*entries):
            mean = sum(w for _, _, w in column) / len(column)
            for _, _, w in column:
                w.copy_(mean)
        if self.average_updater_state:
            mean_upd = _mean_tree([r.updater_state for r in replicas])
            for r in replicas:
                _assign_tree(r.updater_state, mean_upd)
        # the averaging pass is this master's collective phase
        step_phase_histogram().labels("collective").observe(time.perf_counter() - t0)


class SharedTrainingMaster(ParallelTrainer):
    """DL4J's S3: the threshold-encoded gradient-sharing mesh becomes the
    synchronous gradient all-reduce of :class:`ParallelTrainer`.
    ``threshold_algorithm`` is kept for API parity and used only by the
    host-side codecs in ``parallel.compression``."""

    def __init__(self, net=None, mesh: Optional[Mesh] = None,
                 threshold_algorithm=None, batch_size: Optional[int] = None,
                 workers_per_node: Optional[int] = None, **_ignored):
        if net is not None:
            super().__init__(net, mesh)
        else:
            self.net = None
            self._deferred_mesh = mesh
        self.threshold_algorithm = threshold_algorithm
        self.batch_size = batch_size

    def fit_net(self, net, iterator, epochs: int = 1):
        if getattr(self, "net", None) is None:
            super().__init__(net, getattr(self, "_deferred_mesh", None))
        return self.fit(iterator, epochs)
