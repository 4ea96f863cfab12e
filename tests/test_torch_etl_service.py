"""Port parity: the multi-process ETL service
(``deeplearning4j_tpu_torch.data.etl_service``) against the JAX package's,
on the CPU.

The JAX package's ``EtlDataSetIterator`` is not run here: the suite-wide
audit of ``tests/conftest.py`` unlinks every ``tdl_*`` segment of the
machine, so under ``pytest -n`` its rings would be unlinked by other
workers. The port is held instead to JAX's in-process pure functions (the
spec, its order and fingerprint, ``decode_store_batch``,
``augment_batch``, ``produce``, ``shard_batches``, the decoded-batch
cache's files), bit for bit, and then to them through its own ring: two
spawned workers, an epoch drained and a second served from the cache,
``state()``/``set_state()`` resume, a killed worker respawned, a worker's
error re-raised with its traceback, no segment left, no ``tdl_`` name, and
a worker process that never imports torch.
"""

import json
import os
import signal
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch
from PIL import Image

from deeplearning4j_tpu.data import etl_service as JE
from deeplearning4j_tpu_torch.data import etl_service as TE
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from torch_port_fixtures import (_no_leaked_children_or_shm, _own_tdl_shm_segments,  # noqa: F401
                                 reap_leaks)

H = W = 24
PAD = 8
BATCH = 6


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("etl_imgs")
    rs = np.random.RandomState(0)
    for i in range(40):
        d = root / f"c{i % 4}"
        d.mkdir(exist_ok=True)
        side = H + PAD if i % 3 else H + PAD + 6  # some decode at a resize
        Image.fromarray(rs.randint(0, 255, (side, side, 3), dtype=np.uint8)).save(
            d / f"i{i}.jpg", quality=85)
    return str(root)


def _specs(image_dir, cache_dir=None, **kw):
    args = dict(height=H, width=W, batch_size=BATCH, store_pad=PAD, num_classes=10,
                cache_dir=cache_dir, **kw)
    return (JE.ImageEtlSpec.from_directory(image_dir, **args),
            TE.ImageEtlSpec.from_directory(image_dir, **args))


def test_spec_order_fingerprint_and_sharding_equal_jax(image_dir):
    jspec, tspec = _specs(image_dir)
    assert (tspec.files, tspec.label_ids, tspec.num_classes, tspec.store_hw, tspec.num_batches) \
        == (jspec.files, jspec.label_ids, jspec.num_classes, jspec.store_hw, jspec.num_batches)
    np.testing.assert_array_equal(tspec.order(), jspec.order())
    assert tspec.fingerprint() == jspec.fingerprint()
    for rank, world in ((0, 1), (1, 3), (2, 3)):
        assert tspec.for_rank(rank, world).my_batches() == jspec.for_rank(rank, world).my_batches()
    for n, world in ((0, 1), (7, 2), (10, 3), (12, 4)):
        for rank in range(world):
            for eq in (True, False):
                assert TE.shard_batches(n, rank, world, eq) == JE.shard_batches(n, rank, world, eq)
    with pytest.raises(ValueError, match="outside"):
        TE.shard_batches(4, 2, 2)
    with pytest.raises(ValueError, match="num_classes"):
        TE.ImageEtlSpec.from_directory(image_dir, H, W, batch_size=BATCH, num_classes=2)


def test_produce_and_the_cache_equal_jax(image_dir, tmp_path):
    """``decode_store_batch``, ``augment_batch`` (training and centre-crop
    specs, several epochs) and ``produce`` through each package's
    decoded-batch cache: equal arrays, hits on the second pass, and equal
    cache files."""
    jspec, tspec = _specs(image_dir, str(tmp_path / "j"))
    tspec = TE.ImageEtlSpec(**{**tspec.__dict__, "cache_dir": str(tmp_path / "t")})
    jcache, tcache = jspec.open_cache(), tspec.open_cache()
    for b in range(tspec.num_batches):
        js, jl = jspec.decode_store_batch(b)
        ts, tl = tspec.decode_store_batch(b)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tl, jl)
        for epoch in (0, 3):
            np.testing.assert_array_equal(tspec.augment_batch(ts, epoch, b),
                                          jspec.augment_batch(js, epoch, b))
        for pass_ in range(2):
            ti, tl2, thit = tspec.produce(b, pass_, tcache)
            ji, jl2, jhit = jspec.produce(b, pass_, jcache)
            assert thit == jhit == bool(pass_)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl2, jl2)
    assert tcache.done_count() == tspec.num_batches
    key = tspec.fingerprint()
    for f in ("images.u8", "labels.i32", "done.u8"):
        assert (tmp_path / "t" / key / f).read_bytes() == (tmp_path / "j" / key / f).read_bytes()
    eval_spec = TE.ImageEtlSpec(**{**tspec.__dict__, "augment": False})
    jeval = JE.ImageEtlSpec(**{**jspec.__dict__, "augment": False})
    np.testing.assert_array_equal(eval_spec.augment_batch(ts, 1, 0), jeval.augment_batch(js, 1, 0))


def _expected(jspec, epochs):
    """The stream the ring must serve: JAX's ``produce`` of this rank's
    batches, epoch by epoch, labels one-hot."""
    eye = np.eye(jspec.num_classes, dtype=np.float32)
    out = []
    for epoch in range(epochs):
        for b in jspec.my_batches():
            imgs, labels, _ = jspec.produce(b, epoch, None)
            out.append((imgs, eye[labels]))
    return out


@pytest.mark.parametrize("workers,slots", [(2, None), (6, 2)], ids=["two", "six_on_two_slots"])
def test_workers_serve_jax_batches_and_the_cache_from_epoch_two(image_dir, tmp_path, workers,
                                                                slots):
    """Two workers on the default ring, and six (one per batch) contending
    for two slots: every batch arrives once, in order, bit for bit JAX's."""
    jspec, tspec = _specs(image_dir, str(tmp_path / "c"))
    want = _expected(jspec, 2)
    reg = MetricsRegistry()
    with TE.EtlDataSetIterator(tspec, num_workers=workers, ring_slots=slots, registry=reg) as it:
        got = []
        for _ in range(2):
            it.reset()
            while it.has_next():
                ds = it.next()
                assert np.shares_memory(ds.features, it.ring_payload_view())  # zero-copy
                got.append((ds.features.copy(), ds.labels))
        names = [n for n in os.listdir("/dev/shm") if str(os.getpid()) in n]
        assert it._shm.name.startswith(f"tdlt_etl_{os.getpid()}_")
        stats = it.etl_stats()
    assert not any(n.startswith("tdl_") for n in names)  # the port makes no tdl_ segment
    assert len(got) == len(want) == 2 * tspec.num_batches
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert stats["etl_workers"] == workers and stats["ring_slots"] == (slots or 2 * workers)
    assert stats["cache_misses"] == tspec.num_batches
    assert stats["cache_hits"] >= tspec.num_batches - 2  # epoch 2 decodes nothing ...
    assert reg.get("tdl_etl_batches_total").value == len(got)
    assert not _own_tdl_shm_segments()  # ... and the segment is gone


def test_state_resume_and_a_rank_slice(image_dir):
    """A stream closed after 3 batches resumes from ``state()`` in a new
    iterator (``set_state``, then the first ``reset()`` keeps the position)
    and serves the rest of the epoch; rank 1 of 2 serves its own batches."""
    jspec, tspec = _specs(image_dir)
    want = _expected(jspec, 1)
    it = TE.EtlDataSetIterator(tspec, num_workers=1, zero_copy=False, registry=MetricsRegistry())
    first = [it.next().features for _ in range(3)]
    state = it.state()
    it.close()
    assert state == {"epoch": 0, "pos": 3}
    again = TE.EtlDataSetIterator(tspec, num_workers=2, registry=MetricsRegistry())
    again.set_state(state)
    rest = [ds.features.copy() for ds in again]
    again.close()
    for got, (wx, _) in zip(first + rest, want):
        np.testing.assert_array_equal(got, wx)
    assert len(first + rest) == len(want)
    jr, tr = jspec.for_rank(1, 2), tspec.for_rank(1, 2)
    with TE.EtlDataSetIterator(tr, num_workers=1, registry=MetricsRegistry()) as it1:
        got = [ds.features.copy() for ds in it1]
    assert it1.epoch_batches == len(tr.my_batches()) == len(got)
    for g, (wx, _) in zip(got, _expected(jr, 1)):
        np.testing.assert_array_equal(g, wx)


def test_a_killed_worker_is_respawned(image_dir):
    jspec, tspec = _specs(image_dir)
    want = _expected(jspec, 2)
    reg = MetricsRegistry()
    it = TE.EtlDataSetIterator(tspec, num_workers=2, ring_slots=2, zero_copy=False, registry=reg)
    got = [it.next().features]
    os.kill(it._workers[1].proc.pid, signal.SIGKILL)
    it._workers[1].proc.join(5)
    while len(got) < len(want):
        if not it.has_next():
            it.reset()
        got.append(it.next().features)
    it.close()
    assert it.etl_stats()["worker_respawns"] == 1
    assert reg.get("tdl_etl_worker_respawns_total").value == 1
    for g, (wx, _) in zip(got, want):
        np.testing.assert_array_equal(g, wx)


def test_a_worker_error_carries_its_traceback_until_reset(image_dir, tmp_path):
    bad = tmp_path / "bad"
    (bad / "c0").mkdir(parents=True)
    for i in range(BATCH):
        (bad / "c0" / f"i{i}.jpg").write_bytes(b"not an image")
    spec = TE.ImageEtlSpec.from_directory(str(bad), H, W, batch_size=BATCH, store_pad=PAD)
    it = TE.EtlDataSetIterator(spec, num_workers=1, registry=MetricsRegistry())
    with pytest.raises(TE.EtlWorkerError, match="Traceback") as e:
        it.next()
    assert "cannot identify image file" in e.value.traceback_text
    with pytest.raises(TE.EtlWorkerError):
        it.has_next()  # sticky
    it.close()
    assert not _own_tdl_shm_segments()


def test_a_spawned_worker_never_imports_torch(image_dir, tmp_path, monkeypatch):
    """The real worker loop, run in each spawned worker process by
    ``torch_etl_probe`` (which imports no torch), reports the process's
    torch modules after producing a batch: none, while this process has
    torch."""
    import torch_etl_probe

    assert "torch" in __import__("sys").modules
    monkeypatch.setenv("TDLT_ETL_PROBE_DIR", str(tmp_path))
    monkeypatch.setattr(TE, "_etl_worker", torch_etl_probe.worker_and_report)
    _, tspec = _specs(image_dir)
    with TE.EtlDataSetIterator(tspec, num_workers=2, registry=MetricsRegistry()) as it:
        for _ in it:
            pass
        deadline = time.monotonic() + 30
        while len(list(tmp_path.glob("*.json"))) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
    reports = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(reports) == 2 and all(r["produced"] and r["torch"] == [] for r in reports)


def test_sharded_etl_feeds_a_fit_like_the_produced_batches(image_dir):
    """``ParallelTrainer.sharded_etl`` (the ring behind the trainer's
    prefetcher, on the CPU) trains an ingest network exactly as the same
    batches from JAX's ``produce`` do, fed synchronously: bit for bit."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.data.normalizers import (ImagePreProcessingScaler,
                                                           make_device_ingest)
    from deeplearning4j_tpu_torch.nn import conf as TC
    from deeplearning4j_tpu_torch.nn import updaters as TU
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer, ParallelTrainer

    conf = (TC.NeuralNetConfiguration.Builder().seed(3).updater(TU.Adam(1e-2)).list()
            .layer(TC.ConvolutionLayer(n_out=4, kernel_size=(3, 3), stride=(2, 2),
                                       activation="relu"))
            .layer(TC.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(TC.InputType.convolutional(H, W, 3)).build())
    nets = [MultiLayerNetwork(conf, device="cpu").init() for _ in range(2)]
    for n in nets:
        n.set_device_ingest(make_device_ingest(ImagePreProcessingScaler(), "NHWC"))
    jspec, tspec = _specs(image_dir)
    trainer = ParallelTrainer(nets[0])
    it = trainer.sharded_etl(tspec, num_workers=2, prefetch=2)
    assert it._base.zero_copy and it._base.spec.world_size == 1
    trainer.fit(it)
    assert not it._base._started  # fit's finally closed the ring
    nets[1].fit(ListDataSetIterator([DataSet(x, y) for x, y in _expected(jspec, 1)]))
    assert nets[0].score_ == nets[1].score_
    for (_, _, a), (_, _, b) in zip(nets[0]._param_entries(), nets[1]._param_entries()):
        assert torch.equal(a, b)
    bare = MultiProcessTrainer(nets[1]).sharded_etl(tspec, num_workers=1, prefetch=2)
    assert not bare._base.zero_copy  # the host-staged prefetch buffers views


def test_the_audit_finds_a_leaked_port_segment():
    """A port segment of this process left behind is found and unlinked by
    the per-process audit; another process's is not taken."""
    before = _own_tdl_shm_segments()
    mine = shared_memory.SharedMemory(name=f"tdlt_etl_{os.getpid()}_leak", create=True, size=64)
    other = shared_memory.SharedMemory(name="tdlt_etl_1_other", create=True, size=64)
    try:
        assert _own_tdl_shm_segments() - before == {mine.name}
        procs, leaked = reap_leaks(before)
        assert procs == [] and leaked == {mine.name}
        assert not os.path.exists(f"/dev/shm/{mine.name}")
    finally:
        for seg in (mine, other):
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
