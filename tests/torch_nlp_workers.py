"""Worker target of the port's sharded Word2Vec test
(``test_torch_nlp_sharded.py``).

``run`` runs in each worker process that ``deeplearning4j_tpu_torch.parallel.
launcher`` started and initialised (gloo on the CPU). It fits the two-cluster
corpus of the JAX package's cross-process test (``tests/mp_workers.py``
``w2v_shard_train``) with ``Word2Vec(mesh=...)`` over a one-axis mesh of
every rank, once with a vocabulary the axis divides (the tables sharded) and
once with one it does not (the tables replicated), and writes, per case and
rank, the read-back tables, the bytes its collectives moved during the fit,
and the within- and across-cluster similarities to ``TDL_MP_DIR``. Only the
port and numpy are imported here.
"""

import os

import numpy as np

KW = dict(layer_size=16, window=3, negative=4, epochs=20, learning_rate=0.05, batch_size=256,
          min_word_frequency=1, seed=3, subsampling=0.0)


def corpus(n_words):
    """Two clusters of words that never share a sentence: ``a0..`` and
    ``b0..``, ``n_words`` in all (the first cluster takes the odd one)."""
    rs = np.random.RandomState(0)
    a = [f"a{i}" for i in range((n_words + 1) // 2)]
    b = [f"b{i}" for i in range(n_words // 2)]
    sents = []
    for _ in range(400):
        sents.append(" ".join(rs.choice(a, 6)))
        sents.append(" ".join(rs.choice(b, 6)))
    return sents


def cluster_similarities(w2v):
    def sim(u, v):
        u, v = w2v.get_word_vector(u), w2v.get_word_vector(v)
        return float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v) + 1e-9))

    within = np.mean([sim(f"a{i}", f"a{i+1}") for i in range(0, 30, 2)]
                     + [sim(f"b{i}", f"b{i+1}") for i in range(0, 30, 2)])
    across = np.mean([sim(f"a{i}", f"b{i}") for i in range(0, 30, 2)])
    return float(within), float(across)


def run():
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_from_shape

    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = mesh_from_shape({"model": world})
    for n_words in (64, 63):
        before = sum(collectives.traffic.values())
        w2v = Word2Vec(mesh=mesh, device="cpu", **KW).fit(corpus(n_words))
        moved = sum(collectives.traffic.values()) - before
        within, across = cluster_similarities(w2v)
        np.savez(os.path.join(os.environ["TDL_MP_DIR"], f"v{n_words}.rank{rank}.npz"),
                 syn0=w2v.syn0, syn1neg=w2v.syn1neg, moved=np.asarray(moved),
                 within=np.asarray(within), across=np.asarray(across),
                 vocab=np.asarray(w2v.vocab.num_words()))
        dist.barrier()
