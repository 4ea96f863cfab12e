"""The port's FSDP x TP partitioner, held to the JAX package in one process.

Counterpart of ``tests/test_partition.py``: for every bundled network (LeNet,
the char-RNN, ResNet-50, InceptionResNetV1, the attention MLN and the
AttentionVertex graph) and the flagship's ``partition_specs``:

- ``Partitioner.spec_tree`` equals JAX's spec for spec, with the same
  ``uncovered`` and ``replicated_fallback`` reports, on 4- and 8-device
  layouts;
- the block each rank keeps (``sharding.shard_slices`` at the rank's mesh
  coordinates, ``np.unravel_index(rank, shape)``) is the index JAX's
  ``NamedSharding`` gives device ``rank`` of the same mesh;
- ``PartitionReport``'s bytes per rank equal JAX's partitioned arrays' bytes
  on one device.

Also: ``SpecLayout``/``largest_layout``/``describe``, strict refusal of
uncovered parameters, ``ShardingRules`` and ``alternating_dense_rules``,
the placed flagship's blocks and rules, and a deliberate difference:
``dot_product_attention(impl="ring")`` refuses (the JAX package's front
door quietly gives dense attention; the port names the sequence-parallel
functions instead). JAX's large networks come as shape trees
(``jax.eval_shape`` of their ``init``); the port's are initialised on the
CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu import models as JZ
from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import graph_conf as JG
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.attention_layers import AttentionVertex as JAttentionVertex
from deeplearning4j_tpu.nn.attention_layers import RecurrentAttentionLayer as JRecurrent
from deeplearning4j_tpu.nn.attention_layers import SelfAttentionLayer as JSelfAttention
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import partition as JPart
from deeplearning4j_tpu.parallel import sharding as JShard
from deeplearning4j_tpu.parallel.mesh import mesh_from_shape as jmesh_from_shape
from deeplearning4j_tpu_torch import models as TZ
from deeplearning4j_tpu_torch.kernels import attention as TA
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn import graph_conf as TG
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.attention_layers import AttentionVertex, RecurrentAttentionLayer
from deeplearning4j_tpu_torch.nn.attention_layers import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import partition as TPart
from deeplearning4j_tpu_torch.parallel import sharding as TShard
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, use_mesh
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

LAYOUTS = ((1, 2, 2), (2, 2, 1), (1, 4, 1), (2, 2, 2), (1, 4, 2), (1, 1, 8))


def _attention_mln(C, U, SA):
    return (C.NeuralNetConfiguration.Builder().seed(3).updater(U.Adam(1e-2)).list()
            .layer(SA(n_out=16, n_heads=2, head_size=8))
            .layer(C.GlobalPoolingLayer(pooling_type="avg"))
            .layer(C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(C.InputType.recurrent(16, 12)).build())


def _attention_graph(C, G, U, AV, RA):
    g = (C.NeuralNetConfiguration.Builder().seed(13).updater(U.Adam(0.1)).graph_builder()
         .add_inputs("q", "kv")
         .set_input_types(C.InputType.recurrent(8, 5), C.InputType.recurrent(8, 7)))
    g.add_vertex("cross", AV(n_in=8, n_out=8, n_heads=2, head_size=4), "q", "kv", "kv")
    g.add_vertex("self", AV(n_in=8, n_out=8, n_heads=2, head_size=4), "q")
    g.add_layer("rec", RA(n_out=4, n_heads=2, head_size=2), "q")
    g.add_vertex("cat", G.MergeVertex(), "cross", "self", "rec")
    g.add_layer("pool", C.GlobalPoolingLayer(pooling_type="avg"), "cat")
    g.add_layer("out", C.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "pool")
    return g.set_outputs("out").build()


def _shape_graph(conf):
    """A JAX graph whose trees are shape structs (its ``init`` traced, not
    run)."""
    net = JGraph(conf)

    def trees():
        n = JGraph(conf).init()
        return n.params_, n.bn_state, n.updater_state

    net.params_, net.bn_state, net.updater_state = jax.eval_shape(trees)
    return net


def _nets(kind):
    """(JAX network, port network) of ``kind``."""
    if kind == "lenet":
        return JZ.LeNet().init(), TZ.LeNet().init(device="cpu")
    if kind == "char_rnn":
        return (JMLN(JZ.TextGenerationLSTM(vocab_size=16, hidden=32).conf()).init(),
                TZ.TextGenerationLSTM(vocab_size=16, hidden=32).init(device="cpu"))
    if kind == "resnet50":
        return (_shape_graph(JZ.ResNet50(num_classes=10, input_shape=(3, 64, 64)).conf()),
                TZ.ResNet50(num_classes=10, input_shape=(3, 64, 64)).init(device="cpu"))
    if kind == "facenet":
        return (_shape_graph(JZ.InceptionResNetV1().conf()),
                TZ.InceptionResNetV1().init(device="cpu"))
    if kind == "attention_mln":
        return (JMLN(_attention_mln(JC, JU, JSelfAttention)).init(),
                MultiLayerNetwork(_attention_mln(TC, TU, SelfAttentionLayer),
                                  device="cpu").init())
    if kind == "attention_graph":
        jnet = JGraph(_attention_graph(JC, JG, JU, JAttentionVertex, JRecurrent))
        jnet.init()
        return jnet, ComputationGraph(_attention_graph(TC, TG, TU, AttentionVertex,
                                                       RecurrentAttentionLayer),
                                      device="cpu").init()
    raise ValueError(kind)


def _tuples(tree):
    """A spec tree (either package's) with every spec as a plain tuple."""
    if isinstance(tree, (JP, TShard.PartitionSpec)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return type(tree)(_tuples(v) for v in tree)


def _leaves(params, specs, prefix=""):
    """(path, shape, spec) of every leaf of a (params, specs) pair."""
    if isinstance(specs, (JP, TShard.PartitionSpec)):
        yield prefix, tuple(np.shape(params)), specs
    elif isinstance(specs, dict):
        for k in specs:
            yield from _leaves(params[k], specs[k], f"{prefix}/{k}")
    else:
        for i, (p, s) in enumerate(zip(params, specs)):
            yield from _leaves(p, s, f"{prefix}/{i}")


def _jax_mesh(layout):
    d, f, t = layout
    return jmesh_from_shape({"data": d, "fsdp": f, "tp": t}, devices=jax.devices()[:d * f * t])


def _virtual(layout, rank):
    d, f, t = layout
    return Mesh.virtual({"data": d, "fsdp": f, "tp": t}, rank)


@pytest.mark.parametrize("kind", ["lenet", "char_rnn", "resnet50", "facenet", "attention_mln",
                                  "attention_graph"])
def test_spec_trees_reports_and_rank_blocks_equal_jax(kind):
    jnet, tnet = _nets(kind)
    jroles, troles = JPart.param_role_tree(jnet), TPart.param_role_tree(tnet)
    assert troles == jroles
    assert TPart.uncovered_params(TPart.param_tree(tnet), troles) == []
    for layout in LAYOUTS:
        jmesh = _jax_mesh(layout)
        jpart = JPart.Partitioner(JPart.SpecLayout(*layout), mesh=jmesh)
        tpart = TPart.Partitioner(TPart.SpecLayout(*layout), mesh=_virtual(layout, 0))
        jrep, trep = {}, {}
        jspecs = jpart.spec_tree(jnet.params_, jroles, report=jrep)
        tspecs = tpart.spec_tree(TPart.param_tree(tnet), troles, report=trep)
        assert _tuples(tspecs) == _tuples(jspecs), layout
        assert trep == jrep, layout
        assert tpart.describe() == jpart.describe()
        # every rank's block is the index JAX gives the device of that rank
        for path, shape, spec in _leaves(jnet.params_, jspecs):
            index = NamedSharding(jmesh, spec).devices_indices_map(shape)
            for rank, dev in enumerate(jmesh.devices.flat):
                want = tuple(slice(s.start or 0, n if s.stop is None else s.stop)
                             for s, n in zip(index[dev], shape))
                got = TShard.shard_slices(shape, TShard.P(*spec), _virtual(layout, rank))
                assert got == want, (path, layout, rank)


def test_flagship_partition_specs_and_placed_blocks_equal_jax():
    """``partition_specs``/``batch_specs`` are JAX's; ``place_params`` keeps
    on each rank of a (dp, tp, sp) mesh the block JAX's device holds."""
    kw = dict(vocab_size=256, max_len=32, d_model=64, n_heads=4, n_layers=2, d_ff=128)
    jc = J.TransformerConfig(compute_dtype=jnp.float32, sequence_axis="sp", **kw)
    tc = T.TransformerConfig(compute_dtype=torch.float32, sequence_axis="sp",
                             attn_impl="ulysses", **kw)
    assert T.partition_specs(tc) == _tuples(J.partition_specs(jc))
    assert T.batch_specs(tc) == _tuples(J.batch_specs(jc))
    tree = jax.tree.map(np.asarray, J.init_params(jax.random.key(0), jc))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp"))
    specs = J.partition_specs(jc)
    for rank, dev in enumerate(jmesh.devices.flat):
        placed = T.place_params(tree, tc, Mesh.virtual({"dp": 2, "tp": 2, "sp": 2}, rank),
                                device="cpu")
        got = dict(placed.named_parameters())
        for path, shape, spec in _leaves(tree, specs):
            index = NamedSharding(jmesh, spec).devices_indices_map(shape)[dev]
            name = path[1:].replace("/", ".")
            np.testing.assert_array_equal(got[name].detach().numpy(),
                                          tree_leaf(tree, path)[index], err_msg=name)


def tree_leaf(tree, path):
    for k in path[1:].split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_partition_report_bytes_per_rank_equal_jax():
    """LeNet under (1, 2, 2): the port's report on each rank equals JAX's
    totals and the bytes JAX's partitioned arrays hold on that rank's
    device; the network then holds exactly its blocks."""
    from torch_mln_helpers import port_net

    layout = (1, 2, 2)
    jnet = JZ.LeNet().init()
    ports = [port_net(jnet) for _ in range(4)]
    jmesh = _jax_mesh(layout)
    jrep = JPart.Partitioner(JPart.SpecLayout(*layout), mesh=jmesh).partition_net(jnet)
    for rank, (tnet, dev) in enumerate(zip(ports, jmesh.devices.flat)):
        trep = TPart.Partitioner(TPart.SpecLayout(*layout),
                                 mesh=_virtual(layout, rank)).partition_net(tnet)
        held = sum(int(sh.data.nbytes) for leaf in jax.tree.leaves(jnet.params_)
                   for sh in leaf.addressable_shards if sh.device == dev)
        held_opt = sum(int(sh.data.nbytes) for leaf in jax.tree.leaves(jnet.updater_state)
                       for sh in leaf.addressable_shards if sh.device == dev)
        assert trep.params_bytes_total == jrep.params_bytes_total
        assert trep.params_bytes_per_rank == held == jrep.per_device_params_bytes
        assert trep.opt_bytes_per_rank == held_opt
        assert _tuples(trep.specs) == _tuples(jrep.specs)
        assert (trep.uncovered, trep.replicated_fallback) == (jrep.uncovered,
                                                              jrep.replicated_fallback)
        with pytest.raises(RuntimeError, match="partitioned network"):
            tnet.output(np.zeros((1, 1, 28, 28), np.float32))


def test_layouts_strict_refusal_and_pipe():
    for n in (1, 2, 3, 4, 6, 8, 12):
        for kw in ({}, {"tp": 2}, {"data": 2}, {"tp": 3, "data": 2}):
            assert (dataclasses.astuple(TPart.largest_layout(n, **kw))
                    == dataclasses.astuple(JPart.largest_layout(n, **kw)))
    assert (TPart.SpecLayout(2, 2, 2).describe() == JPart.SpecLayout(2, 2, 2).describe())
    part = TPart.Partitioner(TPart.SpecLayout(1, 2, 2), mesh=_virtual((1, 2, 2), 0))
    jpart = JPart.Partitioner(JPart.SpecLayout(1, 2, 2), mesh=_jax_mesh((1, 2, 2)))
    tree = {"0": {"W": np.zeros((4, 6)), "zzz": np.zeros((4,))}}
    with pytest.raises(ValueError, match="does not cover"):
        part.spec_tree(tree)
    loose = TPart.Partitioner(TPart.SpecLayout(1, 2, 2), mesh=_virtual((1, 2, 2), 0),
                              strict=False)
    jloose = JPart.Partitioner(JPart.SpecLayout(1, 2, 2), mesh=_jax_mesh((1, 2, 2)),
                               strict=False)
    trep, jrep = {}, {}
    assert _tuples(loose.spec_tree(tree, report=trep)) == _tuples(
        jloose.spec_tree(tree, report=jrep))
    assert trep == jrep == {"uncovered": ["0/zzz"], "replicated_fallback": []}
    state = {"m": {"0": {"W": 0}}, "t": 3}
    specs = part.spec_tree({"0": {"W": np.zeros((4, 6))}})
    assert _tuples(part.state_spec_tree(state, specs)) == _tuples(
        jpart.state_spec_tree(state, jpart.spec_tree({"0": {"W": np.zeros((4, 6))}})))
    # a pipe axis joins the mesh outermost; the role policy replicates over it
    pipe_layout = TPart.SpecLayout(data=2, fsdp=1, pipe=2)
    pmesh = Mesh.virtual(pipe_layout.shape(), 3)
    assert tuple(pmesh.shape) == ("pipe", "data", "fsdp", "tp")
    ppart = TPart.Partitioner(pipe_layout, mesh=pmesh)
    jppart = JPart.Partitioner(JPart.SpecLayout(data=2, fsdp=1, pipe=2),
                               mesh=jmesh_from_shape({"pipe": 2, "data": 2, "fsdp": 1, "tp": 1},
                                                     devices=jax.devices()[:4]))
    assert ppart.describe() == jppart.describe()
    assert _tuples(ppart.spec_tree({"0": {"W": np.zeros((4, 6))}})) == _tuples(
        jppart.spec_tree({"0": {"W": np.zeros((4, 6))}}))
    assert TPart.PipelinePartitioner(pipe_layout, mesh=pmesh).describe() == ppart.describe()
    with pytest.raises(NotImplementedError, match="item 8.7"):
        TPart.Partitioner(TPart.SpecLayout(1, 1, 1), mesh=Mesh.virtual({"expert": 2, "data": 1,
                                                                         "fsdp": 1, "tp": 1}, 0))


def test_sharding_rules_and_alternating_dense_rules_equal_jax():
    params = {"0": {"W": np.zeros((6, 8)), "b": np.zeros((8,))},
              "1": {"W": np.zeros((8, 3)), "b": np.zeros((3,))},
              "2": {"gamma": np.zeros((3,))}}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    for rules, jrules in ((TShard.alternating_dense_rules(), JShard.alternating_dense_rules()),
                          (TShard.ShardingRules(default=TShard.TP_COLUMN),
                           JShard.ShardingRules(default=JShard.TP_COLUMN)),
                          (TShard.ShardingRules(), JShard.ShardingRules())):
        assert _tuples(rules.spec_tree(params)) == _tuples(jrules.spec_tree(params))
        _, jspecs = jrules.shard_tree(jax.tree.map(jnp.asarray, params), mesh)
        for rank in range(4):
            blocks, specs = rules.shard_tree(params, Mesh.virtual({"data": 2, "model": 2}, rank))
            assert _tuples(specs) == _tuples(jspecs)
    vmesh = Mesh.virtual({"data": 2, "model": 2}, 3)
    assert TShard.batch_sharding(vmesh) == ("data",)
    rows = TShard.shard_batch({"x": np.arange(8)}, vmesh)["x"]
    np.testing.assert_array_equal(rows, [4, 5, 6, 7])


def test_mesh_coordinates_follow_jax_device_order():
    """Rank r sits at ``np.unravel_index(r, shape)``: where JAX's
    ``mesh_from_shape`` puts device r."""
    shape = {"data": 2, "fsdp": 2, "tp": 2}
    jmesh = _jax_mesh((2, 2, 2))
    for rank in range(8):
        m = Mesh.virtual(shape, rank)
        pos = np.argwhere(jmesh.devices == jax.devices()[rank])[0]
        assert tuple(m.coords.values()) == tuple(pos)
        assert m.axis_index(("fsdp", "tp")) == pos[1] * 2 + pos[2]
        assert m.axis_ranks("tp") == [m.rank_at({"tp": 0}), m.rank_at({"tp": 1})]
    pm = Mesh.virtual({"pipe": 2, "data": 2}, 1)  # rank 1: pipe 0, data 1 (JAX's order)
    assert pm.coords == {"pipe": 0, "data": 1} and pm.axis_ranks("pipe") == [1, 3]
    with pytest.raises(NotImplementedError, match="item 8.7"):
        Mesh.virtual({"expert": 2}, 0)


def _flagship_cfgs(attn_impl, sequence_axis):
    kw = dict(vocab_size=256, max_len=32, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              dropout=0.0)
    return (J.TransformerConfig(compute_dtype=jnp.float32, **kw),
            T.TransformerConfig(compute_dtype=torch.float32, attn_impl=attn_impl,
                                sequence_axis=sequence_axis, **kw))


def test_front_door_refuses_ring_and_names_the_sequence_parallel_functions():
    """A deliberate difference: JAX's ``dot_product_attention(impl="ring")``
    quietly gives dense attention; the port's names the function to call."""
    q = torch.zeros((1, 2, 8, 4))
    for impl, fn in (("ring", "ring_attention"), ("ulysses", "ulysses_attention")):
        with pytest.raises(ValueError, match=rf"{fn}\(q, k, v, axis_name="):
            TA.dot_product_attention(q, q, q, impl=impl)
    q3 = torch.zeros((1, 3, 8, 4))
    with use_mesh(Mesh.virtual({"sp": 2}, 0)), pytest.raises(ValueError, match="heads"):
        TA.ulysses_attention(q3, q3, q3, axis_name="sp")


def test_placed_config_rules():
    """``attn_impl="ring"`` without ``sequence_axis`` raises as in JAX; a
    placed model refuses the serving entry points and remat."""
    _, tc = _flagship_cfgs("ring", None)
    model = T.init_params(0, dataclasses.replace(tc, attn_impl="xla"), device="cpu")
    with pytest.raises(ValueError, match="requires sequence_axis"):
        T.forward(model, np.zeros((1, 4), np.int64), tc)
    jc, tc = _flagship_cfgs("ulysses", "sp")
    tree = jax.tree.map(np.asarray, J.init_params(jax.random.key(0), jc))
    mesh = Mesh.virtual({"dp": 1, "tp": 2, "sp": 2}, 3)
    placed = T.place_params(tree, tc, mesh, device="cpu")
    assert tuple(placed.blocks[0].qkv_w.shape) == (64, 96)
    assert tuple(placed.embed.tok.shape) == (128, 64)
    np.testing.assert_array_equal(placed.embed.tok.detach().numpy(), tree["embed"]["tok"][128:])
    with pytest.raises(RuntimeError, match="placed on a mesh"):
        T.forward(placed, np.zeros((1, 4), np.int64), tc)
    with pytest.raises(ValueError, match="remat"):
        T.place_params(tree, dataclasses.replace(tc, remat=True), mesh, device="cpu")
    as_tuples = lambda tree: jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, JP))  # noqa: E731
    assert T.partition_specs(tc) == as_tuples(J.partition_specs(jc))
    jsp = dataclasses.replace(jc, sequence_axis="sp")
    assert T.batch_specs(tc) == as_tuples(J.batch_specs(jsp))
