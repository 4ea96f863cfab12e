"""The fleet's ``lenet_images`` trial task, port against the JAX package.

One trial of three steps on both packages from the same PNG directory and
seed: equal batches (bit for bit), parameters within the fleet tests'
``TASK_ATOL`` (1e-5 absolute) of the JAX network's, equal ``evaluate``. A
second task over the same ``cache_dir`` decodes nothing: every batch it
produces is a cache hit in ``tdl_etl_cache_hits_total``.
"""

import jax
import numpy as np
from PIL import Image

from deeplearning4j_tpu.arbiter import trial_worker as JW
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.arbiter import trial_worker as TW
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.monitoring.etl import etl_metrics
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

TASK_ATOL = 1e-5  # as tests/test_torch_fleet.py: parameters after a few steps, absolute


def _images(root, n=24, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    for i in range(n):
        d = root / f"c{i % classes}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 255, (16, 16), dtype=np.uint8), mode="L").save(
            d / f"i{i:03d}.png")
    return root


def _spec(data_dir, cache_dir):
    # bench.py's hpo leg: height and width 12, one channel, batch 8, store_pad 2, seed 5
    return {"kind": "lenet_images", "data_dir": str(data_dir), "cache_dir": str(cache_dir),
            "height": 12, "width": 12, "channels": 1, "batch": 8, "store_pad": 2, "seed": 5}


def _counts():
    m = etl_metrics()
    return m.cache_hits.value, m.cache_misses.value


def test_lenet_images_trial_equals_jax_and_a_second_task_only_hits(tmp_path):
    data = _images(tmp_path / "imgs")
    hp = {"learning_rate": 3e-3, "conv_channels": 6, "hidden": 16}
    jt = JW.build_task(_spec(data, tmp_path / "jax_cache"))
    h0, m0 = _counts()
    tt = TW.build_task(_spec(data, tmp_path / "cache"))
    assert (tt.num_batches, tt.spec.num_classes) == (jt.num_batches, 4) == (3, 4)
    jnet = jt.build_net(hp)
    tnet = port_net(jnet)
    assert tnet.conf.to_json() == tt.build_net(hp, device="cpu").conf.to_json()
    for it in range(3):
        (jx, jy), (tx, ty) = jt.batch(it), tt.batch(it)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.shape == (8, 1, 12, 12) and tx.dtype == np.float32 and tx.max() <= 1.0
        jnet.fit(JDataSet(jx, jy))
        tnet.fit(DataSet(tx, ty))
    want = jax.tree.map(np.asarray, jnet.params_)
    for si, k, p in tnet._param_entries():
        np.testing.assert_allclose(p.detach().numpy(), want[si][k], rtol=0, atol=TASK_ATOL)
    assert tt.evaluate(tnet) == jt.evaluate(jnet)
    h1, m1 = _counts()
    assert m1 - m0 == 3  # the first pass over the 3 batches decoded them
    assert h1 - h0 == 3  # evaluate's pass found them in the cache

    second = TW.build_task(_spec(data, tmp_path / "cache"))
    for it in range(3):
        x, y = second.batch(it)
        np.testing.assert_array_equal(x, tt.batch(it)[0])
    second.evaluate(tnet)
    h2, m2 = _counts()
    assert m2 - m1 == 0 and h2 - h1 == 3 + 3 + 3  # only hits
