"""The port's pipeline parallelism across real process boundaries, held to
the JAX package and to the port's one-process step.

Two gloo gangs on the CPU, started through the port's
``parallel.launcher.launch`` (workers in ``tests/torch_pipeline_workers.py``):
two ranks on a ``pipe=2`` mesh and four on ``pipe=4``, ``(dp, pipe) = (2, 2)``
and ``SpecLayout(data=2, pipe=2)``. The JAX references run here on the
CPU mesh's first four devices, jitted.

- the generic pipeline (a residual stage) against the sequential
  composition, both schedules (outputs 1e-6, gradients 1e-5 relative);
- ``transformer_pp_loss_fn`` within 1e-6 relative of the one-process
  ``loss_fn`` and 2e-5 of JAX's pipelined loss; GPipe and 1F1B losses
  bitwise equal, gradients within 1e-6 of each leaf's norm;
- one ``make_pp_train_step`` with Adam, staged and canonical layouts,
  against JAX's (loss 2e-5, each gathered gradient and updated leaf 1e-4 of
  its norm);
- ragged boundaries with ``pad_mask`` and ``segments``, and remat;
- the ticks each rank ran: ``M + S - 1`` forward, ``M + 2S - 1`` for the
  1F1B backward, a stash of ``min(M, 2S - 1)``;
- ``PipelineParallelTrainer``: cost-model boundaries, two 1F1B steps, stage
  profiles, a rebalance that moves the split, and a third step, against
  JAX's trainer.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu.monitoring.costmodel import balance_stages
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.parallel import pipeline as JPP
from deeplearning4j_tpu.parallel.mesh import mesh_from_shape as jmesh_from_shape
from deeplearning4j_tpu.parallel.partition import PipelinePartitioner as JPipelinePartitioner
from deeplearning4j_tpu.parallel.partition import SpecLayout as JSpecLayout
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import params_from_jax
from deeplearning4j_tpu_torch.parallel import launcher
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

WORKERS = os.path.join(os.path.dirname(__file__), "torch_pipeline_workers.py")
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}
ONE_PROCESS_REL = 1e-6
JAX_LOSS_REL = 2e-5
SCHEDULE_REL = 1e-6
STEP_REL = 1e-4
LR = 1e-2
# a ragged split fixed by hand (stage-ok: test fixture, as JAX's tests/test_pipeline.py)
RAGGED = [(0, 2), (2, 6)]


def _jcfg(remat=False):
    return J.TransformerConfig(vocab_size=64, max_len=32, d_model=16, n_heads=2, n_layers=6,
                               d_ff=32, dropout=0.0, param_dtype=jnp.float32,
                               compute_dtype=jnp.float32, remat=remat)


def _tcfg(remat=False):
    return T.TransformerConfig(vocab_size=64, max_len=32, d_model=16, n_heads=2, n_layers=6,
                               d_ff=32, dropout=0.0, compute_dtype=torch.float32, remat=remat)


def _batch(B=8, T_=16, seed=0, aux=False):
    rs = np.random.RandomState(seed)
    b = {"tokens": rs.randint(0, 64, (B, T_)).astype(np.int32),
         "labels": rs.randint(0, 64, (B, T_)).astype(np.int32),
         "weights": (rs.rand(B, T_) > 0.3).astype(np.float32)}
    if aux:
        b["pad_mask"] = (rs.rand(B, T_) > 0.25).astype(np.float32)
        b["pad_mask"][:, 0] = 1.0
        b["segments"] = rs.randint(0, 2, (B, T_)).astype(np.int32)
    return b


@pytest.fixture(scope="module")
def jparams():
    """The JAX ``init_params`` tree (numpy) and its canonical pipeline tree."""
    tree = jax.tree.map(np.asarray, J.init_params(jax.random.key(0), _jcfg()))
    return tree, jax.tree.map(np.asarray, JPP.canonical_pp_params(tree))


def _jmesh(dp, pipe):
    return JMesh(np.array(jax.devices()[:dp * pipe]).reshape(dp, pipe), ("dp", "pipe"))


def _generic_arrays(S, M, seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(S, 8).astype(np.float32), "b": rs.randn(S, 8).astype(np.float32),
            "xs": rs.randn(M, 2, 8).astype(np.float32)}


def _cases(canon):
    flat = {f"p/{top}/{k}": v for top in canon for k, v in canon[top].items()}
    both = ["gpipe", "1f1b"]
    b8, b16 = _batch(), _batch(B=16, seed=1)
    bflat = lambda b: {f"b/{k}": v for k, v in b.items()}  # noqa: E731
    two = lambda L: balance_stages([1.0] * L, 2)  # noqa: E731
    cases = [
        ({"name": "generic2", "kind": "generic", "ranks": 2, "S": 2}, _generic_arrays(2, 6, 1)),
        ({"name": "generic4", "kind": "generic", "ranks": 4, "S": 4}, _generic_arrays(4, 6, 2)),
        ({"name": "plain2", "kind": "loss", "ranks": 2, "mesh": {"pipe": 2}, "M": 4,
          "boundaries": two(6), "schedules": both}, {**flat, **bflat(b8)}),
        ({"name": "remat2", "kind": "loss", "ranks": 2, "mesh": {"pipe": 2}, "M": 4,
          "boundaries": two(6), "schedules": both, "remat": True}, {**flat, **bflat(b8)}),
        ({"name": "aux2", "kind": "loss", "ranks": 2, "mesh": {"pipe": 2}, "M": 4,
          "boundaries": RAGGED, "schedules": both},
         {**flat, **bflat(_batch(seed=3, aux=True))}),
        ({"name": "dp2pipe2", "kind": "loss", "ranks": 4, "mesh": {"dp": 2, "pipe": 2}, "M": 4,
          "boundaries": two(6), "schedules": both}, {**flat, **bflat(b8)}),
        ({"name": "pipe4", "kind": "loss", "ranks": 4, "mesh": {"pipe": 4}, "M": 4,
          "boundaries": balance_stages([1.0] * 6, 4), "schedules": both},
         {**flat, **bflat(b8)}),
        ({"name": "step_staged", "kind": "step", "ranks": 4, "mesh": {"dp": 2, "pipe": 2},
          "M": 4, "boundaries": None, "schedules": ["1f1b"], "lr": LR}, {**flat, **bflat(b8)}),
        ({"name": "step_canonical", "kind": "step", "ranks": 4, "mesh": {"dp": 2, "pipe": 2},
          "M": 4, "boundaries": RAGGED, "schedules": ["gpipe"], "lr": LR},
         {**flat, **bflat(b8)}),
        ({"name": "trainer", "kind": "trainer", "ranks": 4, "M": 4, "lr": LR},
         {**flat, **bflat(b16)}),
    ]
    return cases


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jparams):
    d = tmp_path_factory.mktemp("torch_pipeline")
    cases = _cases(jparams[1])
    for spec, arrays in cases:
        np.savez(d / f"{spec['name']}.npz", **arrays)
    (d / "cases.json").write_text(json.dumps([spec for spec, _ in cases]))
    for n in (2, 4):
        results = launcher.launch(f"{WORKERS}:run_cases", n_processes=n, platform="cpu",
                                  extra_env={**ENV, "TDL_MP_DIR": str(d)}, timeout=240)
        for r in results:
            assert r.returncode == 0, f"{n}-rank gang, rank {r.rank} failed:\n{r.stderr[-3000:]}"
    return {spec["name"]: ({**spec, "arrays": arrays},
                           [dict(np.load(d / f"{spec['name']}.rank{r}.npz"))
                            for r in range(spec["ranks"])])
            for spec, arrays in cases}


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) /
                 max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


def _grads_of(rank, prefix):
    return {k[len(prefix) + 3:]: v for k, v in rank.items() if k.startswith(prefix + "/g/")}


def _one_process(jtree, batch, remat=False):
    """The port's one-process loss and gradients (``blocks`` stacked)."""
    model = params_from_jax(jtree, _tcfg(remat), device="cpu")
    loss = T.loss_fn(model, batch, _tcfg(remat), train=False)
    (grads,) = T._grads(loss, model)
    out = {}
    for name, g in grads.items():
        parts = name.split(".")
        out.setdefault("blocks/" + parts[-1] if parts[0] == "blocks" else
                       f"{parts[0]}/{parts[-1]}", []).append(g.numpy())
    return float(loss), {k: np.stack(v) if k.startswith("blocks/") else v[0]
                         for k, v in out.items()}


def _jax_loss_and_grads(canon, batch, mesh, schedule, boundaries):
    f = JPP.transformer_pp_loss_fn(_jcfg(), 4, mesh, pipe_axis="pipe", schedule=schedule,
                                   boundaries=boundaries)
    loss, g = jax.jit(jax.value_and_grad(f))(jax.tree.map(jnp.asarray, canon),
                                             jax.tree.map(jnp.asarray, batch))
    return float(loss), {f"{top}/{k}": np.asarray(v) for top in g for k, v in g[top].items()}


# ------------------------------------------------------------ generic pipeline


@pytest.mark.parametrize("name", ["generic2", "generic4"])
def test_generic_pipeline_matches_sequential(gang, name):
    """A residual stage ``x + tanh(x w_s + b_s)`` over S stages, both
    schedules, against the sequential composition (outputs 1e-6, gradients
    of every stage's parameters and of xs 1e-5 relative)."""
    spec, ranks = gang[name]
    a = spec["arrays"]
    w = torch.tensor(a["w"], dtype=torch.float64, requires_grad=True)
    b = torch.tensor(a["b"], dtype=torch.float64, requires_grad=True)
    xs = torch.tensor(a["xs"], dtype=torch.float64, requires_grad=True)
    h = xs
    for s in range(spec["S"]):
        h = h + torch.tanh(h * w[s] + b[s])
    h.square().sum().backward()
    for sched in ("gpipe", "1f1b"):
        for s, r in enumerate(ranks):
            np.testing.assert_allclose(r[f"{sched}/ys"], h.detach().numpy(), rtol=1e-6,
                                       atol=1e-6)
            assert _rel(r[f"{sched}/dw"][0], w.grad[s].numpy()) <= 1e-5
            assert _rel(r[f"{sched}/db"][0], b.grad[s].numpy()) <= 1e-5
            assert _rel(r[f"{sched}/dxs"], xs.grad.numpy()) <= 1e-5


# ---------------------------------------------------------------- loss parity


@pytest.mark.parametrize("name,dp,pipe", [("dp2pipe2", 2, 2), ("pipe4", 1, 4)])
def test_pipelined_loss_matches_one_process_and_jax(gang, jparams, name, dp, pipe):
    """Cost-balanced boundaries (at pipe=4 ragged, the blocks stored whole):
    every rank's loss within 1e-6 of the one-process ``loss_fn`` and 2e-5 of
    JAX's pipelined loss, both schedules; the gathered gradients within 1e-4
    of JAX's."""
    spec, ranks = gang[name]
    batch = {k[2:]: v for k, v in spec["arrays"].items() if k.startswith("b/")}
    ref, _ = _one_process(jparams[0], batch)
    for sched in ("gpipe", "1f1b"):
        jloss, jgrads = _jax_loss_and_grads(jparams[1], batch, _jmesh(dp, pipe), sched,
                                            spec["boundaries"])
        for r in ranks:
            got = float(r[f"{sched}/loss"])
            assert abs(got - ref) / abs(ref) <= ONE_PROCESS_REL, (sched, got, ref)
            assert abs(got - jloss) / abs(jloss) <= JAX_LOSS_REL, (sched, got, jloss)
        for k, v in _grads_of(ranks[0], sched).items():
            assert _rel(v, jgrads[k]) <= STEP_REL, (sched, k, _rel(v, jgrads[k]))


@pytest.mark.parametrize("name", ["plain2", "dp2pipe2", "pipe4"])
def test_gpipe_and_1f1b_losses_bitwise_equal(gang, name):
    """The same fill-drain forward: losses bitwise equal on every rank; the
    1F1B backward's gradients within 1e-6 of each leaf's norm of GPipe's."""
    _, ranks = gang[name]
    for r in ranks:
        assert r["gpipe/loss"] == r["1f1b/loss"]
        g, f = _grads_of(r, "gpipe"), _grads_of(r, "1f1b")
        for k in g:
            assert _rel(f[k], g[k]) <= SCHEDULE_REL, (k, _rel(f[k], g[k]))
    for r in ranks[1:]:  # every rank holds the same loss and gathered gradients
        for k in r:
            if k.endswith("/loss") or "/g/" in k:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_ragged_boundaries_with_pad_mask_and_segments(gang, jparams):
    """Boundaries [(0, 2), (2, 6)] (stage 1 fetches layer 2 from stage 0's
    chunk), ``pad_mask`` as per-microbatch aux and ``segments`` in the
    embedding: the one-process loss within 1e-6 and its gradients within
    1e-5, both schedules."""
    spec, ranks = gang["aux2"]
    batch = {k[2:]: v for k, v in spec["arrays"].items() if k.startswith("b/")}
    ref, grads = _one_process(jparams[0], batch)
    for sched in ("gpipe", "1f1b"):
        for r in ranks:
            assert abs(float(r[f"{sched}/loss"]) - ref) / abs(ref) <= ONE_PROCESS_REL
        for k, v in _grads_of(ranks[0], sched).items():
            assert _rel(v, grads[k]) <= 1e-5, (sched, k, _rel(v, grads[k]))
    run = json.loads(str(ranks[1]["gpipe/run"]))
    assert run["fetched_bytes"] > 0 and json.loads(str(ranks[0]["gpipe/run"]))[
        "fetched_bytes"] == 0


def test_remat_gives_the_plain_schedules_gradients(gang):
    """``cfg.remat`` (each in-stage layer through ``_remat_block``): loss
    and every gradient within 1e-6 of the plain schedule's, both
    schedules."""
    _, plain = gang["plain2"]
    _, remat = gang["remat2"]
    for sched in ("gpipe", "1f1b"):
        for p, r in zip(plain, remat):
            assert abs(float(r[f"{sched}/loss"]) - float(p[f"{sched}/loss"])) <= \
                1e-6 * abs(float(p[f"{sched}/loss"]))
            g, h = _grads_of(p, sched), _grads_of(r, sched)
            for k in g:
                assert _rel(h[k], g[k]) <= 1e-6, (sched, k)


@pytest.mark.parametrize("name,M", [("plain2", 4), ("generic2", 6), ("generic4", 6),
                                    ("pipe4", 4)])
def test_ticks_each_rank_ran(gang, name, M):
    """Structural, no clock: the forward runs ``M + S - 1`` ticks with M
    stage units on each rank, GPipe's backward as many, and 1F1B's backward
    ``M + 2S - 1`` ticks with a stash of ``min(M, 2S - 1)`` and M forward
    units on top of the fill-drain's."""
    _, ranks = gang[name]
    S = len(ranks)
    for r in ranks:
        g, f = json.loads(str(r["gpipe/run"])), json.loads(str(r["1f1b/run"]))
        assert (g["forward_ticks"], g["backward_ticks"]) == (M + S - 1, M + S - 1)
        assert (g["stage_forwards"], g["stage_backwards"]) == (M, M)
        assert (f["forward_ticks"], f["backward_ticks"]) == (M + S - 1, M + 2 * S - 1)
        assert f["stash_slots"] == min(M, 2 * S - 1)
        assert (f["stage_forwards"], f["stage_backwards"]) == (2 * M, M)


# ----------------------------------------------------------------- train step


@pytest.mark.parametrize("name", ["step_staged", "step_canonical"])
def test_train_step_matches_jax(gang, jparams, name):
    """One ``make_pp_train_step`` with Adam at (dp, pipe) = (2, 2), the
    staged [S, L/S, ...] layout and the canonical one with ragged
    boundaries, against JAX's ``make_pp_train_step``: the loss within 2e-5,
    each updated leaf within 1e-4 of its norm and its update within 1e-3 of
    the update's norm, Adam's moments too."""
    spec, ranks = gang[name]
    batch = {k[2:]: jnp.asarray(v) for k, v in spec["arrays"].items() if k.startswith("b/")}
    mesh = _jmesh(2, 2)
    upd = JAdam(LR)
    if spec["boundaries"] is None:
        p0 = JPP.pipeline_transformer_params(jax.tree.map(jnp.asarray, jparams[0]), 2)
    else:
        p0 = jax.tree.map(jnp.asarray, jparams[1])
    step = jax.jit(JPP.make_pp_train_step(_jcfg(), upd, 4, mesh, pipe_axis="pipe",
                                          schedule=spec["schedules"][0],
                                          boundaries=spec["boundaries"]))
    p1, opt, loss = step(p0, upd.init(p0), batch, jnp.asarray(0))
    r = ranks[0]
    assert abs(float(r["loss"]) - float(loss)) / abs(float(loss)) <= JAX_LOSS_REL

    def whole(x):
        x = np.asarray(x)
        return x.reshape((6,) + x.shape[2:]) if spec["boundaries"] is None and x.ndim >= 2 \
            and x.shape[0] == 2 and x.shape[1] == 3 else x

    for top in ("embed", "blocks", "mlm"):
        for k in p1[top]:
            want = whole(p1[top][k]) if top == "blocks" else np.asarray(p1[top][k])
            before = jparams[1][top][k]
            got = r[f"p/{top}/{k}"]
            assert _rel(got, want) <= STEP_REL, (top, k)
            assert _rel(got - before, want - before) <= 1e-3, (top, k)
            for slot in ("m", "v"):
                w = opt[slot][top][k]
                w = whole(w) if top == "blocks" else np.asarray(w)
                assert _rel(r[f"{slot}/{top}/{k}"], w) <= 1e-3, (slot, top, k)
    for other in ranks[1:]:
        for k in r:
            np.testing.assert_array_equal(other[k], r[k], err_msg=k)


# -------------------------------------------------------------------- trainer


def test_pipeline_trainer_trains_profiles_and_rebalances(gang, jparams):
    """``PipelineParallelTrainer(SpecLayout(data=2, pipe=2))`` on 4 ranks, B=16,
    M=4: the cost model's boundaries [(0, 3), (3, 6)], two 1F1B steps that
    lower the loss, profiled stage fractions within 15% of the predicted,
    no rebalance on balanced timings, a forced 2x skew that moves the split
    to [(0, 2), (2, 6)] (the counter once, one ``pipe_rebalance`` event with
    JAX's fields), and a third step on the new split; the three losses
    within 2e-5 of JAX's trainer on the same steps."""
    spec, ranks = gang["trainer"]
    batch = {k[2:]: jnp.asarray(v) for k, v in spec["arrays"].items() if k.startswith("b/")}
    jmesh = jmesh_from_shape({"pipe": 2, "data": 2, "fsdp": 1, "tp": 1},
                             devices=jax.devices()[:4])
    jt = JPP.PipelineParallelTrainer(
        jax.tree.map(jnp.asarray, jparams[0]), _jcfg(), JAdam(LR),
        JPipelinePartitioner(JSpecLayout(data=2, pipe=2), mesh=jmesh), n_microbatches=4)
    jlosses = []
    for _ in range(2):
        jt._fit_batch(batch)
        jlosses.append(float(jt.net.score_))
    assert jt.maybe_rebalance([2.0, 1.0]) == [(0, 2), (2, 6)]
    jt._fit_batch(batch)
    jlosses.append(float(jt.net.score_))
    for rank, r in enumerate(ranks):
        assert r["bounds0"].tolist() == [[0, 3], [3, 6]]
        losses = r["losses"]
        assert np.all(np.isfinite(losses)) and losses[1] < losses[0]
        np.testing.assert_allclose(losses, jlosses, rtol=JAX_LOSS_REL, atol=0)
        m_frac = r["times"] / r["times"].sum()
        p_frac = r["predicted"] / r["predicted"].sum()
        assert np.all(np.abs(m_frac - p_frac) / p_frac <= 0.15), (r["times"], r["predicted"])
        assert bool(r["balanced"])
        assert r["bounds1"].tolist() == [[0, 2], [2, 6]]
        assert int(r["counter"]) == 1
        (ev,) = json.loads(str(r["events"]))
        assert ev["old_boundaries"] == [[0, 3], [3, 6]]
        assert ev["new_boundaries"] == [[0, 2], [2, 6]]
        assert ev["skew"] == pytest.approx(2.0 / 1.5)
        assert int(r["iteration"]) == 3
        # stage 1 (ranks at pipe coordinate 1) fetches layer 2 from stage 0's chunk
        assert (int(r["fetched"]) > 0) == (rank // 2 == 1)
    for k in ranks[0]:
        if k.startswith("s/"):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
