"""The port's pipeline planning, trees and refusals, in one process, held to
the JAX package.

- the stage partitioner (``balance_stages``, ``stage_costs``) and the stage
  maps (``uniform_boundaries``, ``stage_index_map``) equal JAX's on its
  hand-computed cases and on seeded random cost lists, and every error
  message keeps JAX's content;
- ``monitoring.costmodel.layer_costs`` rows and ``graph_stage_partition``
  equal JAX's for LeNet, the char-RNN and a small ResNet-50;
- the canonical and staged trees, ``pipeline_partition_specs`` and
  ``PipelinePartitioner.spec_tree`` equal JAX's leaf for leaf, and the
  weight bridge cuts a rank's pipeline state (parameters and Adam's
  moments) as JAX's sharding does and gathers it back;
- the refusals: a plain trainer given a pipe layout, a pipeline trainer
  without one, dropout, an unknown schedule, a data axis the mesh lacks,
  and ``mlm_positions`` (a deliberate difference: the JAX pipelined loss
  fails on the logits' shape there, the port names the cause).

The schedules themselves run across processes:
``test_torch_pipeline_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu import models as JZ
from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu.monitoring import costmodel as JCost
from deeplearning4j_tpu.monitoring import partition as JMon
from deeplearning4j_tpu.monitoring.registry import MetricsRegistry as JMetricsRegistry
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.parallel import partition as JPart
from deeplearning4j_tpu.parallel import pipeline as JPP
from deeplearning4j_tpu.parallel.mesh import mesh_from_shape as jmesh_from_shape
from deeplearning4j_tpu_torch import models as TZ
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import (params_from_jax, pipeline_state_from_jax,
                                                     pipeline_state_to_jax)
from deeplearning4j_tpu_torch.monitoring import costmodel as TCost
from deeplearning4j_tpu_torch.monitoring import partition as TMon
from deeplearning4j_tpu_torch.monitoring.registry import MetricsRegistry
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.parallel import partition as TPart
from deeplearning4j_tpu_torch.parallel import pipeline as TPP
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from deeplearning4j_tpu_torch.parallel.trainer import MultiProcessTrainer, ParallelTrainer
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

costs = st.lists(st.floats(min_value=0.0, max_value=1e6, allow_nan=False), min_size=1,
                 max_size=12)


def _jcfg(n_layers=6, **kw):
    return J.TransformerConfig(vocab_size=64, max_len=32, d_model=16, n_heads=2,
                               n_layers=n_layers, d_ff=32, dropout=0.0,
                               param_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)


def _tcfg(n_layers=6, **kw):
    kw.setdefault("dropout", 0.0)
    return T.TransformerConfig(vocab_size=64, max_len=32, d_model=16, n_heads=2,
                               n_layers=n_layers, d_ff=32, compute_dtype=torch.float32, **kw)


def _jtree(n_layers=6, seed=0):
    return jax.tree.map(np.asarray, J.init_params(jax.random.key(seed), _jcfg(n_layers)))


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not type(tree).__name__.endswith("PartitionSpec"):
        return [_tuples(v) for v in tree]
    return tuple(tree)


def _same_tree(got, want):
    assert set(got) == set(want)
    for top in want:
        assert set(got[top]) == set(want[top]), top
        for k in want[top]:
            g = got[top][k]
            g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, np.asarray(want[top][k]), err_msg=f"{top}/{k}")


# ------------------------------------------------------------ stage planning


def test_balance_stages_and_stage_costs_hand_computed():
    """JAX's pinned cases: the min-max split, the earliest cut of equal
    splits, uniform costs, and a 2x-skewed front half."""
    cases = [([1, 1, 1, 3], 2, [(0, 3), (3, 4)]), ([3, 1, 1, 1], 2, [(0, 1), (1, 4)]),
             ([1] * 6, 2, [(0, 3), (3, 6)]), ([2, 2, 2, 1, 1, 1], 2, [(0, 2), (2, 6)]),
             ([1, 1, 1], 2, [(0, 1), (1, 3)])]
    for c, S, want in cases:
        assert TCost.balance_stages(c, S) == JCost.balance_stages(c, S) == want
        assert TCost.stage_costs(c, want) == JCost.stage_costs(c, want)
    assert TCost.stage_costs([1, 1, 1, 3], [(0, 3), (3, 4)]) == [3.0, 3.0]


@settings(max_examples=60, deadline=None)
@given(costs, st.integers(min_value=1, max_value=5))
def test_balance_stages_equals_jax_on_random_costs(c, S):
    if len(c) < S:
        with pytest.raises(ValueError) as t:
            TCost.balance_stages(c, S)
        with pytest.raises(ValueError) as j:
            JCost.balance_stages(c, S)
        assert str(t.value) == str(j.value)
        return
    got = TCost.balance_stages(c, S)
    assert got == JCost.balance_stages(c, S)
    assert TCost.stage_costs(c, got) == JCost.stage_costs(c, got)
    assert TPP.transformer_stage_boundaries(None, S, costs=c) == got


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=1, max_value=12), st.integers(min_value=1, max_value=6))
def test_uniform_boundaries_and_stage_index_map_equal_jax(L, S):
    if L % S:
        with pytest.raises(ValueError) as t:
            TPP.uniform_boundaries(L, S)
        with pytest.raises(ValueError) as j:
            JPP.uniform_boundaries(L, S)
        assert str(t.value) == str(j.value)
    else:
        assert TPP.uniform_boundaries(L, S) == JPP.uniform_boundaries(L, S)
    if L >= S:
        bounds = TCost.balance_stages([1.0 + (i % 3) for i in range(L)], S)
        for t, j in zip(TPP.stage_index_map(bounds, L), JPP.stage_index_map(bounds, L)):
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype


def test_error_messages_keep_jax_content():
    """Ragged depth without boundaries names both numbers and the fix;
    non-contiguous, empty, short and misplaced boundaries, the partitioner's
    own refusals and a stage-count mismatch read as JAX's."""
    def same(t_call, j_call):
        with pytest.raises(ValueError) as t:
            t_call()
        with pytest.raises(ValueError) as j:
            j_call()
        assert str(t.value) == str(j.value)
        return str(t.value)

    msg = same(lambda: TPP.pipeline_transformer_params(_jtree(5), 2),
               lambda: JPP.pipeline_transformer_params(_jtree(5), 2))
    assert "5 layers" in msg and "2 pipeline stages" in msg and "balance_stages" in msg
    for bad in ([], [(1, 3)], [(0, 2), (3, 5)], [(0, 2), (2, 2), (2, 5)]):
        same(lambda: TPP.stage_index_map(bad), lambda: JPP.stage_index_map(bad))
    same(lambda: TPP.stage_index_map([(0, 2), (2, 5)], 6),
         lambda: JPP.stage_index_map([(0, 2), (2, 5)], 6))
    same(lambda: TPP.pipeline_transformer_params(_jtree(6), 3, boundaries=[(0, 2), (2, 6)]),
         lambda: JPP.pipeline_transformer_params(_jtree(6), 3, boundaries=[(0, 2), (2, 6)]))
    for c, S in (([1.0], 0), ([1.0, -1.0], 1), ([1.0], 2)):
        same(lambda: TCost.balance_stages(c, S), lambda: JCost.balance_stages(c, S))
    with pytest.raises(ValueError, match="boundaries describe 3 stages but mesh axis 'pipe' "
                                         "has 2 shards"):
        TPP.transformer_pp_loss_fn(_tcfg(), 2, Mesh.virtual({"pipe": 2}, 0),
                                   boundaries=[(0, 2), (2, 4), (4, 6)])


# --------------------------------------------------- per-layer cost rows


def _shape_graph(conf):
    """A JAX graph whose trees are zeros of its init's shapes (traced, not run)."""
    net = JGraph(conf)

    def trees():
        n = JGraph(conf).init()
        return n.params_, n.bn_state, n.updater_state

    shapes = jax.eval_shape(trees)
    net.params_, net.bn_state, net.updater_state = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    return net


def _nets(kind):
    if kind == "lenet":
        return JZ.LeNet().init(), TZ.LeNet().init(device="cpu")
    if kind == "char_rnn":
        return (JMLN(JZ.TextGenerationLSTM(vocab_size=16, hidden=32).conf()).init(),
                TZ.TextGenerationLSTM(vocab_size=16, hidden=32).init(device="cpu"))
    return (_shape_graph(JZ.ResNet50(num_classes=10, input_shape=(3, 64, 64)).conf()),
            TZ.ResNet50(num_classes=10, input_shape=(3, 64, 64)).init(device="cpu"))


@pytest.mark.parametrize("kind", ["lenet", "char_rnn", "resnet50"])
def test_layer_costs_and_graph_stage_partition_equal_jax(kind):
    jnet, tnet = _nets(kind)
    for batch, train in ((16, True), (3, False)):
        assert TCost.layer_costs(tnet, batch, train) == JCost.layer_costs(jnet, batch, train)
    for S in (2, 3):
        assert TPP.graph_stage_partition(tnet, 16, S) == JPP.graph_stage_partition(jnet, 16, S)


def test_costmodel_xla_half_raises_naming_item_8_6():
    for call in (lambda: TCost.xla_step_cost(lambda: 0), lambda: TCost.live_hbm_breakdown(),
                 lambda: TCost.cost_table([]),
                 lambda: TCost.cost_table([], xla={"flops": 1.0})):
        with pytest.raises(NotImplementedError, match="item 8.6"):
            call()


def test_transformer_stage_boundaries_equal_jax():
    for L, S in ((6, 2), (12, 4), (5, 2)):
        for seq in (None, 16):
            assert TPP.transformer_stage_boundaries(_tcfg(L), S, seq=seq) == \
                JPP.transformer_stage_boundaries(_jcfg(L), S, seq=seq)


# ------------------------------------------------------------------- trees


def test_canonical_and_staged_trees_equal_jax():
    """``canonical_pp_params`` of the port's ``Transformer`` and of the
    numpy tree, ``stack_blocks``/``unstack_blocks`` and
    ``pipeline_transformer_params`` (staged, and canonical with boundaries)
    equal JAX's leaf for leaf; a ``microbatch`` round trip."""
    jtree = _jtree()
    want = jax.tree.map(np.asarray, JPP.canonical_pp_params(jtree))
    model = params_from_jax(jtree, _tcfg(), device="cpu")
    _same_tree(TPP.canonical_pp_params(model), want)
    _same_tree(TPP.canonical_pp_params(jtree), want)
    assert TPP.canonical_pp_params(want) is want
    back = TPP.unstack_blocks(TPP.stack_blocks(jtree["blocks"]), 6)
    for a, b in zip(back, jtree["blocks"]):
        _same_tree({"b": a}, {"b": b})
    _same_tree(TPP.pipeline_transformer_params(jtree, 2),
               jax.tree.map(np.asarray, JPP.pipeline_transformer_params(jtree, 2)))
    _same_tree(TPP.pipeline_transformer_params(jtree, 2, boundaries=[(0, 2), (2, 6)]), want)
    x = torch.arange(24.0).reshape(8, 3)
    assert torch.equal(TPP.unmicrobatch(TPP.microbatch(x, 4)), x)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        TPP.microbatch(x, 3)


LAYOUTS = {"data4_pipe2": (dict(data=4, pipe=2), {"pipe": 2, "data": 4, "fsdp": 1, "tp": 1}, 6),
           "data1_fsdp2": (dict(data=1, fsdp=2), {"data": 1, "fsdp": 2, "tp": 1}, 6),
           "pipe2_ragged": (dict(data=1, fsdp=1, pipe=2),
                            {"pipe": 2, "data": 1, "fsdp": 1, "tp": 1}, 5)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_partition_specs_and_rank_state_equal_jax(name):
    """``pipeline_partition_specs`` and ``PipelinePartitioner.spec_tree`` of
    the canonical tree equal JAX's (a pipe that does not divide L leaves the
    blocks whole); each rank's pipeline state from the weight bridge equals
    the block JAX's sharding places on its device, parameters and Adam's
    moments, and gathers back into the JAX tree."""
    kw, shape, L = LAYOUTS[name]
    n = int(np.prod(list(shape.values())))
    jtree = _jtree(L)
    canon = jax.tree.map(np.asarray, JPP.canonical_pp_params(jtree))
    staged_ok = L % 2 == 0
    if staged_ok:
        staged = JPP.pipeline_transformer_params(jtree, 2)
        assert _tuples(TPP.pipeline_partition_specs(TPP.pipeline_transformer_params(jtree, 2))) \
            == _tuples(JPP.pipeline_partition_specs(staged))
    jmesh = jmesh_from_shape(shape, devices=jax.devices()[:n])
    jpart = JPart.PipelinePartitioner(JPart.SpecLayout(**kw), mesh=jmesh)
    jspecs = jpart.spec_tree(canon)
    rs = np.random.RandomState(1)
    opt = {slot: jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32), canon)
           for slot in ("m", "v")}
    assert set(JAdam(1e-3).init(canon)) == set(opt)
    placed = {"p": jpart.place(jax.tree.map(jnp.asarray, canon), jspecs),
              **{s: jpart.place(jax.tree.map(jnp.asarray, opt[s]), jspecs) for s in opt}}
    states = []
    for rank in range(n):
        tpart = TPart.PipelinePartitioner(TPart.SpecLayout(**kw), mesh=Mesh.virtual(shape, rank))
        assert _tuples(tpart.spec_tree(canon)) == _tuples(jspecs)
        assert tpart.describe() == jpart.describe()
        params, upd = pipeline_state_from_jax(canon, TPart.SpecLayout(**kw), rank, n, opt,
                                              device="cpu")
        dev = jmesh.devices.flat[rank]

        def shard(tree, top, k):
            (sh,) = [s for s in tree[top][k].addressable_shards if s.device == dev]
            return np.asarray(sh.data)

        for top in canon:
            for k in canon[top]:
                np.testing.assert_array_equal(params[top][k].numpy(), shard(placed["p"], top, k))
                for slot in opt:
                    np.testing.assert_array_equal(upd[slot][f"{top}.{k}"].numpy(),
                                                  shard(placed[slot], top, k))
        states.append((params, upd))
    p, u = pipeline_state_to_jax(states, TPart.SpecLayout(**kw), L)
    _same_tree(p, canon)
    for slot in opt:
        _same_tree(u[slot], opt[slot])


# ----------------------------------------------------------------- refusals


def test_plain_trainers_refuse_a_pipe_layout():
    """As JAX's guard: a plain trainer given a pipe layout names the
    pipeline trainer (before any mesh is built)."""
    net = TPP._PipelineNet(TPP.canonical_pp_params(_jtree()))
    for trainer in (ParallelTrainer, MultiProcessTrainer):
        with pytest.raises(ValueError, match="PipelineParallelTrainer"):
            trainer(net, mesh_layout=TPart.SpecLayout(data=4, pipe=2))
        with pytest.raises(ValueError, match="pipe=2"):
            trainer(net, mesh_layout=TPart.PipelinePartitioner(
                TPart.SpecLayout(data=1, fsdp=1, pipe=2),
                mesh=Mesh.virtual({"pipe": 2, "data": 1, "fsdp": 1, "tp": 1}, 0)))


def test_pipeline_trainer_refusals():
    """pipe=1 and an unknown schedule raise as in JAX."""
    with pytest.raises(ValueError, match="pipe axis of size >= 2"):
        TPP.PipelineParallelTrainer(_jtree(), _tcfg(), Adam(1e-3),
                                    TPart.SpecLayout(data=4, fsdp=2), n_microbatches=4,
                                    device="cpu")
    with pytest.raises(ValueError, match="unknown pipeline schedule 'zb'"):
        TPP.PipelineParallelTrainer(_jtree(), _tcfg(), Adam(1e-3),
                                    TPart.SpecLayout(data=4, pipe=2), n_microbatches=4,
                                    schedule="zb", device="cpu")


def test_loss_fn_refusals():
    """Dropout above 0 (JAX's message), an unknown schedule, a mesh without
    the pipe axis, a data axis the mesh lacks, and ``mlm_positions``, which
    the JAX pipelined loss never reads (it fails on the logits' shape); the
    port refuses it naming the cause."""
    mesh = Mesh.virtual({"dp": 1, "pipe": 2}, 0)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "pipe"))
    with pytest.raises(ValueError) as t:
        TPP.transformer_pp_loss_fn(_tcfg(dropout=0.1), 4, mesh)
    with pytest.raises(ValueError) as j:
        JPP.transformer_pp_loss_fn(_jcfg().__class__(**{**_jcfg().__dict__, "dropout": 0.1}),
                                   4, jmesh)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        TPP.transformer_pp_loss_fn(_tcfg(), 4, mesh, schedule="interleaved")
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        TPP.spmd_pipeline(lambda p, x: x, {}, torch.zeros(2, 1), mesh, schedule="interleaved")
    with pytest.raises(ValueError, match="mesh has no 'pipe' axis"):
        TPP.transformer_pp_loss_fn(_tcfg(), 4, Mesh.virtual({"dp": 1}, 0))
    assert TPP.resolve_data_axis(mesh, "auto") == JPP.resolve_data_axis(jmesh, "auto") == "dp"
    assert TPP.resolve_data_axis(Mesh.virtual({"pipe": 1}, 0), "auto") is None
    with pytest.raises(ValueError) as t:
        TPP.transformer_pp_loss_fn(_tcfg(), 4, mesh, data_axis="data")
    with pytest.raises(ValueError) as j:
        JPP.resolve_data_axis(jmesh, "data")
    assert str(t.value) == str(j.value)
    loss = TPP.transformer_pp_loss_fn(_tcfg(), 2, mesh)
    batch = {"tokens": np.zeros((4, 8), np.int64), "labels": np.zeros((4, 3), np.int64),
             "mlm_positions": np.zeros((4, 3), np.int64)}
    with pytest.raises(ValueError, match="mlm_positions is not read"):
        loss(TPP.pipeline_transformer_params(_jtree(), 2), batch)


def test_pipe_metric_families_equal_jax():
    """``tdl_pipe_*``: names, help text, kinds and labels of JAX's
    ``pipe_metrics``; the bubble family is declared and never set."""
    t, j = TMon.pipe_metrics(MetricsRegistry()), JMon.pipe_metrics(JMetricsRegistry())
    for attr in ("stages", "bubble", "stage_seconds", "rebalances"):
        a, b = getattr(t, attr), getattr(j, attr)
        assert (a.name, a.help, tuple(a.label_names), type(a).__name__) == \
            (b.name, b.help, tuple(b.label_names), type(b).__name__)
