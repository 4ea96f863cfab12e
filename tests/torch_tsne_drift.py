"""How far phase 14b's t-SNE on the card parts from the CPU's: the
measurement behind ``chip_smoke.py``'s ``TSNE_Y_REL`` and ``TSNE_KL_REL``.

    python3 tests/torch_tsne_drift.py [runs]   (default 30; needs the card)

Each run fits phase 14a's Word2Vec on the card (its ``index_add_`` atomics
give a slightly different table each time), takes the t-SNE affinities of
the table on the CPU, and compares the card with the CPU over the first 10
steps from the same start: run freely, and one step at a time from the CPU
run's state before it. It prints each run's largest errors of the embedding
(of its largest magnitude) and of the KL, then their spread.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch import set_fp32_numerics  # noqa: E402
from deeplearning4j_tpu_torch.nlp import tsne as TS  # noqa: E402
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: E402


def _rel(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


def one_run(sentences, tsne, kw):
    x = Word2Vec(**cs.W2V_KW).fit(sentences).syn0
    n = x.shape[0]
    perp = min(tsne.perplexity, max((n - 1) / 3.0, 2.0))
    p = TS._cond_probs(TS._pairwise_sq_dists(torch.from_numpy(x)), perp)
    ps = (p + p.T) / (2.0 * n)
    y0 = tsne._initial_y(n)
    steps = cs.TSNE_STEPS_CHECKED
    y_card, kl_card = TS._tsne_run(ps.cuda(), y0.cuda(), n_iter=steps, **kw)
    y_cpu, kl_cpu = TS._tsne_run(ps, y0, n_iter=steps, **kw)
    eye, ps_card = torch.eye(n, dtype=torch.bool), ps.cuda()
    eye_card = eye.cuda()
    state, step_y, step_kl = (y0, torch.zeros_like(y0), torch.ones_like(y0)), 0.0, 0.0
    for i in range(steps):
        cpu = TS._tsne_step(ps, eye, i, *state, **kw)
        card = TS._tsne_step(ps_card, eye_card, i, *(t.cuda() for t in state), **kw)
        step_y = max(step_y, _rel(card[0], cpu[0]))
        step_kl = max(step_kl, _rel(card[3], cpu[3]))
        state = cpu[:3]
    return {"free_y": _rel(y_card, y_cpu),
            "free_kl": float(((kl_card.cpu() - kl_cpu).abs() / kl_cpu.abs()).max()),
            "step_y": step_y, "step_kl": step_kl}


def main(runs):
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    set_fp32_numerics()
    print(cs.card_line(), flush=True)
    sentences = cs.w2v_corpus()
    Word2Vec(**cs.W2V_KW).fit(sentences)  # warm
    tsne = TS.BarnesHutTsne(seed=17)
    kw = dict(learning_rate=tsne.learning_rate, momentum_final=tsne.momentum,
              exaggeration=tsne.exaggeration, exaggeration_iters=min(250, tsne.n_iter // 2))
    rows = []
    for r in range(runs):
        rows.append(one_run(sentences, tsne, kw))
        print(r, json.dumps(rows[-1]), flush=True)
    for key in rows[0]:
        v = [row[key] for row in rows]
        print(f"{key}: min {min(v):.3e} median {float(np.median(v)):.3e} max {max(v):.3e} "
              f"(n={runs})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 30))
