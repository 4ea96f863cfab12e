"""Port parity: the asynchronous iterators (``AsyncDataSetIterator``,
``DevicePrefetchIterator``) and their consumers, against the JAX package's,
on the CPU.

The same batches in the same order as the base and as JAX's wrapper; a
worker's error re-raised after the buffered batches and on every later call
until ``reset()``; ``reset()`` stops the worker after O(queue) batches, not
O(epoch); ``close()`` joins it and leaves the iterator usable;
``stats()`` has the JAX package's keys; a prefetched fit (the MLN's, the
graph's, ``ParallelTrainer.fit(prefetch=)``, the ParallelWrapper's) equals
the synchronous one bit for bit. The card's staging (pinned buffers, the
copy stream, the event) runs in ``chip_smoke.py`` phase 7d.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import iterators as JI
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.monitoring import MetricsRegistry as JRegistry
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator, DataSet, DataSetIterator,
                                           DevicePrefetchIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _data(n=7, batch=4, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, 5).astype(np.float32),
             np.eye(3, dtype=np.float32)[rs.randint(0, 3, batch)]) for _ in range(n)]


class _Counting(DataSetIterator):
    """A base that counts what it produced and can fail at one batch."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at, self.pos, self.produced = batches, fail_at, 0, 0
        self.closed = 0

    def has_next(self):
        return self.pos < len(self.batches)

    def next(self):
        if self.pos == self.fail_at:
            self.pos += 1
            raise RuntimeError(f"bad record {self.fail_at}")
        x, y = self.batches[self.pos]
        self.pos += 1
        self.produced += 1
        return DataSet(x, y)

    def reset(self):
        self.pos = 0

    def batch(self):
        return 4


@pytest.mark.parametrize("device_staged", [False, True], ids=["async", "device_cpu"])
def test_order_equals_the_base_and_jax(device_staged):
    data = _data()
    base = ListDataSetIterator([DataSet(x, y) for x, y in data])
    it = (DevicePrefetchIterator(base, buffer_size=2, device="cpu", registry=MetricsRegistry())
          if device_staged else AsyncDataSetIterator(base, queue_size=2))
    jit = JI.AsyncDataSetIterator(JI.ListDataSetIterator([JDataSet(x, y) for x, y in data]), 2)
    for _ in range(2):  # two epochs
        got = [(ds.features, ds.labels) for ds in it]
        want = [(np.asarray(ds.features), np.asarray(ds.labels)) for ds in jit]
        assert len(got) == len(want) == len(data)
        for (gx, gy), (wx, wy), (x, y) in zip(got, want, data):
            assert np.array_equal(gx, wx) and np.array_equal(gx, x) and np.array_equal(gy, y)
    assert it.batch() == 4


def test_a_worker_error_is_sticky_until_reset():
    base = _Counting(_data(), fail_at=3)
    it = AsyncDataSetIterator(base, queue_size=2)
    got = []
    with pytest.raises(RuntimeError, match="bad record 3"):
        while it.has_next():
            got.append(it.next())
    assert len(got) == 3  # the batches before the failure were delivered
    for call in (it.has_next, it.next):
        with pytest.raises(RuntimeError, match="bad record 3"):
            call()
    base.fail_at = None
    it.reset()
    assert len(list(it)) == 7


def test_reset_stops_in_o_queue_and_close_joins():
    base = _Counting(_data(n=200))
    it = AsyncDataSetIterator(base, queue_size=3)
    assert it.has_next()
    it.next()
    threads = threading.active_count()
    it.reset()
    assert base.produced <= 1 + 3 + 2  # consumed + queue + in flight, never the epoch
    assert it._thread is None and threading.active_count() < threads
    it.next()
    it.close()  # joins without resetting the base ...
    assert it._thread is None and base.pos > 0
    assert it.has_next()  # ... and the worker restarts on next use
    it.close()


def test_close_frees_a_restartable_base_only():
    for restartable in (True, False):
        base = _Counting(_data())
        base.restartable_close = restartable
        base.close = lambda b=base: setattr(b, "closed", b.closed + 1)
        it = AsyncDataSetIterator(base)
        it.has_next()
        it.close()
        assert base.closed == int(restartable)


def test_stats_keys_equal_jax_and_the_card_is_the_default():
    data = _data(n=5)
    it = DevicePrefetchIterator(ListDataSetIterator([DataSet(x, y) for x, y in data]),
                                device="cpu", registry=MetricsRegistry())
    jit = JI.DevicePrefetchIterator(JI.ListDataSetIterator([JDataSet(x, y) for x, y in data]),
                                    registry=JRegistry())
    list(it)
    list(jit)
    assert set(it.stats()) == set(jit.stats())
    s = it.stats()
    assert s["epoch_steps"] == jit.stats()["epoch_steps"] == 6  # five batches and the end
    assert s["starved_steps"] >= 0 and len(it.wait_seconds) == 6
    assert s["h2d_bytes"] == 0  # nothing crossed to a card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            DevicePrefetchIterator(ListDataSetIterator([]))  # the card by default


def _mln_conf(C, U):
    return (C.NeuralNetConfiguration.Builder().seed(5).updater(U.Adam(1e-2)).list()
            .layer(C.DenseLayer(n_in=5, n_out=8, activation="tanh"))
            .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent")).build())


def _same_params(a, b):
    return all(torch.equal(p, q) for (_, _, p), (_, _, q) in
               zip(a._param_entries(), b._param_entries()))


def test_prefetched_fits_equal_the_synchronous_fit_bitwise():
    """The MLN's ``fit`` over a ``DevicePrefetchIterator`` and over an
    ``AsyncDataSetIterator``, ``ParallelTrainer.fit(prefetch=2)`` and the
    ParallelWrapper's ``prefetch_buffer``: each two epochs, the same scores
    and parameters as the synchronous fit, bit for bit."""
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

    data = _data(n=5, batch=6, seed=1)
    jnet = JNet(_mln_conf(JC, JU)).init()
    base = lambda: ListDataSetIterator([DataSet(x, y) for x, y in data])  # noqa: E731
    sync = port_net(jnet).fit(base(), epochs=2)
    runs = {
        "device": lambda n: n.fit(DevicePrefetchIterator(base(), device="cpu",
                                                         registry=MetricsRegistry()), epochs=2),
        "async": lambda n: n.fit(AsyncDataSetIterator(base(), 2), epochs=2),
        "trainer": lambda n: ParallelTrainer(n).fit(base(), epochs=2, prefetch=2),
        "wrapper": lambda n: ParallelWrapper(n, prefetch_buffer=3).fit(base(), epochs=2),
    }
    for name, run in runs.items():
        net = port_net(jnet)
        run(net)
        assert net.iteration == sync.iteration and net.score_ == sync.score_, name
        assert _same_params(net, sync), name


def test_trainer_staging_surfaces():
    """``batch_sharding()`` (this rank's rows, on the network's device),
    ``prefetch()`` (a DevicePrefetchIterator on that device; whole batches
    under bucketing, which pads before it splits), MultiProcessTrainer's
    host-staged ``prefetch()``."""
    from deeplearning4j_tpu_torch.common.bucketing import BucketSpec
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer, ParallelTrainer

    net = port_net(JNet(_mln_conf(JC, JU)).init())
    trainer = ParallelTrainer(net)
    sh = trainer.batch_sharding()
    assert (sh.rank, sh.world, sh.device.type) == (0, 1, "cpu")
    assert sh.divides(5) and np.array_equal(sh.rows(np.arange(6)), np.arange(6))
    pre = trainer.prefetch(ListDataSetIterator([]), buffer_size=3)
    assert isinstance(pre, DevicePrefetchIterator) and pre.device.type == "cpu"
    assert pre._sharding is not None and pre._size == 3
    net.set_bucketing(BucketSpec())
    assert trainer.prefetch(ListDataSetIterator([]))._sharding is None
    mp = MultiProcessTrainer(port_net(JNet(_mln_conf(JC, JU)).init()))
    staged = mp.prefetch(ListDataSetIterator([]))
    assert type(staged) is AsyncDataSetIterator
    assert mp._prefetch_buffers_host_views and not trainer._prefetch_buffers_host_views


def test_fit_closes_the_prefetch_worker_when_a_step_raises():
    net = port_net(JNet(_mln_conf(JC, JU)).init())
    data = _data(n=50)
    bad = [(x, y) for x, y in data]
    bad[2] = (np.zeros((4, 7), np.float32), bad[2][1])  # a batch of the wrong width
    it = AsyncDataSetIterator(ListDataSetIterator([DataSet(x, y) for x, y in bad]), 2)
    with pytest.raises(RuntimeError):
        net.fit(it)
    assert it._thread is None  # joined in fit's finally
