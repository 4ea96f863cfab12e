"""``Word2Vec(mesh=...)`` across real process boundaries: its tables' rows
owned in blocks over the mesh's first axis (``nlp.word2vec.RowBlocks``).

A two-rank gloo gang on the CPU (workers in ``tests/torch_nlp_workers.py``)
mirrors the JAX package's cross-process test (``tests/test_multiprocess.py``
``test_w2v_embedding_shards_across_processes``): the two-cluster corpus with
V = 64 over the axis, 20 epochs. Every rank reads back the same syn0 and
syn1neg (hash-equal), words that share sentences embed closer than words
that never do, and the tables are within 1e-5 of the port's one-process fit
(the collectives add zeros: in practice they are equal bit for bit). With
V = 63, which the axis does not divide, the tables are replicated, as the
JAX package places them: the fit runs no collective and equals the
one-process fit too.
"""

import hashlib
import os

import numpy as np
import pytest

from deeplearning4j_tpu_torch.nlp import Word2Vec
from deeplearning4j_tpu_torch.parallel import launcher
from torch_nlp_workers import KW, corpus
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)
from torch_port_fixtures import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORKERS = os.path.join(os.path.dirname(__file__), "torch_nlp_workers.py")
ATOL = 1e-5


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_nlp_sharded")
    results = launcher.launch(f"{WORKERS}:run", n_processes=2, platform="cpu",
                              extra_env={"TDL_MP_DIR": str(d), "OMP_NUM_THREADS": "1"},
                              timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    return {n: [dict(np.load(d / f"v{n}.rank{r}.npz")) for r in range(2)] for n in (64, 63)}


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


@pytest.mark.parametrize("n_words", [64, 63], ids=["sharded", "replicated"])
def test_word2vec_tables_across_two_ranks(gang, n_words):
    r0, r1 = gang[n_words]
    assert int(r0["vocab"]) == n_words
    for name in ("syn0", "syn1neg"):
        assert _digest(r0[name]) == _digest(r1[name]), name
    # sharded: one all-reduce per update and the read-back; replicated: none
    assert (int(r0["moved"]) > 0) == (n_words == 64)
    assert float(r0["within"]) > float(r0["across"]) + 0.1, (r0["within"], r0["across"])
    ref = Word2Vec(device="cpu", **KW).fit(corpus(n_words))
    for name in ("syn0", "syn1neg"):
        np.testing.assert_allclose(r0[name], getattr(ref, name), rtol=0, atol=ATOL, err_msg=name)
