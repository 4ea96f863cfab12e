"""The pipeline's ring hops under NCCL, one card per rank.

A four-rank NCCL gang started through ``parallel.launcher.launch`` (worker:
``tests/torch_pipeline_workers.py`` ``run_cases``, the generic case) runs a
residual stage ``x + tanh(x w_s + b_s)`` over ``pipe=4`` and over
``data=2 x pipe=2``, both schedules, and holds it against the sequential
composition of the whole batch on the same card: outputs 1e-6, gradients of
every stage's parameters and of xs 1e-5 relative. Nothing may stage through
the host. A pipeline's first hop is a batched p2p among two ranks of the
pipe group, which NCCL only takes after the group has run an operation of
all its ranks (``mesh.build_mesh`` runs one).

Needs four CUDA cards; skips elsewhere. Imports no JAX, so it runs on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_pipeline_nccl.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel import launcher

WORKERS = os.path.join(os.path.dirname(__file__), "torch_pipeline_workers.py")
OUT_TOL = 1e-6
GRAD_REL = 1e-5


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) /
                 max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


@pytest.mark.cuda
def test_pipeline_over_nccl_matches_sequential(tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards, one NCCL rank each")
    rs = np.random.RandomState(7)
    arrays = {"w": rs.randn(4, 8).astype(np.float32), "b": rs.randn(4, 8).astype(np.float32),
              "xs": rs.randn(6, 4, 8).astype(np.float32)}
    cases = [{"name": "nccl_pipe4", "kind": "generic", "ranks": 4, "mesh": {"pipe": 4}},
             {"name": "nccl_data2_pipe2", "kind": "generic", "ranks": 4,
              "mesh": {"data": 2, "pipe": 2}}]
    for spec in cases:
        S = spec["mesh"]["pipe"]
        np.savez(tmp_path / f"{spec['name']}.npz", w=arrays["w"][:S], b=arrays["b"][:S],
                 xs=arrays["xs"])
    (tmp_path / "cases.json").write_text(json.dumps(cases))
    results = launcher.launch(f"{WORKERS}:run_cases", n_processes=4, platform="cuda",
                              extra_env={"TDL_MP_DIR": str(tmp_path)}, timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    for spec in cases:
        n_data, S = spec["mesh"].get("data", 1), spec["mesh"]["pipe"]
        for rank in range(4):
            got = dict(np.load(tmp_path / f"{spec['name']}.rank{rank}.npz"))
            assert str(got["backend"]) == "nccl"
            assert json.loads(str(got["staged"])) == {}, "a transfer staged through the host"
            d, s = divmod(rank, S) if n_data > 1 else (0, rank)  # rank r at unravel_index(r)
            rows = slice(d * 4 // n_data, (d + 1) * 4 // n_data)
            for sched in ("gpipe", "1f1b"):
                np.testing.assert_allclose(got[f"{sched}/ys"], got["ref/ys"][:, rows],
                                           rtol=OUT_TOL, atol=OUT_TOL)
                assert _rel(got[f"{sched}/dw"][0], got["ref/dw"][s]) <= GRAD_REL
                assert _rel(got[f"{sched}/db"][0], got["ref/db"][s]) <= GRAD_REL
                assert _rel(got[f"{sched}/dxs"], got["ref/dxs"][:, rows]) <= GRAD_REL
