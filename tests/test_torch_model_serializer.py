"""Port ``serde.model_serializer`` against the JAX package's, on the CPU: one
zip format.

A zip written by either package restores into the other with the
parameters, updater state and BN statistics equal bit for bit, and the
counters and score carried, for LeNet, the char-RNN and a BN graph with
Merge and ElementWise vertices; a bfloat16 network's zip too. ResNet-50 at
its published widths (25,557,032 parameters; 3x64x64 inputs; seeded numpy
values in the JAX package's parameter and BN trees):
the JAX package's zip restores into the port bit for bit, and the restored network's
output on [1,3,64,64] equals, bit for bit, that of the same weights loaded
through ``models.weights.cg_params_from_jax`` (the JAX forward is not run,
to keep the file's time down). ``ModelGuesser`` restores the zip and refuses
what is not ported (Keras HDF5, TF GraphDef: ROADMAP item 8.8); a
normalizer is refused on write (item 8.5) and ignored on restore, as in
the JAX package.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import ResNet50 as JResNet50
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.serde import ModelSerializer as JMS
from deeplearning4j_tpu_torch.models import ResNet50, cg_params_from_jax
from deeplearning4j_tpu_torch.serde import ModelGuesser, ModelSerializer
from torch_ckpt_helpers import KINDS, assert_same_state, batch, jax_net, port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _train(net, kind, jax_side, steps=2):
    for i in range(steps):
        jds, tds = batch(kind, i)
        net.fit(jds if jax_side else tds)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_zip_restores_into_the_port(kind, tmp_path):
    jnet = jax_net(kind)
    _train(jnet, kind, True)
    path = str(tmp_path / "m.zip")
    JMS.write_model(jnet, path)
    tnet = ModelSerializer.restore(path, device="cpu")
    assert type(tnet).__name__ == type(jnet).__name__
    assert_same_state(tnet, jnet)
    assert (tnet.iteration, tnet.epoch, tnet.score_) == (2, 2, float(jnet.score_))


@pytest.mark.parametrize("kind", KINDS)
def test_port_zip_restores_into_jax(kind, tmp_path):
    tnet = port_net(kind)
    _train(tnet, kind, False)
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(tnet, path)
    jnet = JMS.restore(path)
    assert_same_state(tnet, jnet)
    assert (jnet.iteration, jnet.epoch, jnet.score_) == (2, 2, tnet.score_)
    again = ModelSerializer.restore_multi_layer_network(path, device="cpu") \
        if kind != "bn_graph" else ModelSerializer.restoreComputationGraph(path, device="cpu")
    assert_same_state(again, jnet)


def test_bf16_zip_from_jax_restores_bitwise(tmp_path):
    jnet = jax_net("bf16_mln")
    path = str(tmp_path / "bf16.zip")
    JMS.write_model(jnet, path)
    tnet = ModelSerializer.restore(path, device="cpu")
    assert all(p.dtype == torch.bfloat16 for _, _, p in tnet._param_entries())
    assert_same_state(tnet, jnet)


def _jax_resnet50():
    """The JAX package's ResNet-50 with every leaf of its parameter and BN
    trees drawn from a seeded numpy generator and its Nesterovs state zero,
    as its ``init`` leaves it: the trees' structure comes from
    ``jax.eval_shape`` of that ``init``, which takes about 13 s to run
    eagerly on the CPU. Weights are scaled by their fan-in and BN scales
    kept below 1, so the 50-layer forward stays finite and its softmax far
    from one-hot."""
    conf = JResNet50(input_shape=(3, 64, 64)).conf()
    jnet = JComputationGraph(conf)

    def trees():
        net = JComputationGraph(conf).init()
        return net.params_, net.bn_state, net.updater_state

    rs = np.random.RandomState(50)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if path[0].key == "v":
            return jnp.zeros(shape, leaf.dtype)
        if name == "W":
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            a = rs.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "gamma":
            a = rs.uniform(0.2, 0.6, shape)
        elif name == "var":
            a = rs.uniform(0.5, 1.5, shape)
        else:
            a = rs.standard_normal(shape) * 0.1
        return jnp.asarray(a.astype(leaf.dtype))

    shapes = jax.eval_shape(trees)
    jnet.params_, jnet.bn_state, jnet.updater_state = (
        jax.tree_util.tree_map_with_path(draw, t) for t in shapes)
    return jnet


def test_resnet50_zip_from_jax_restores_bitwise(tmp_path):
    jnet = _jax_resnet50()
    path = str(tmp_path / "resnet50.zip")
    JMS.write_model(jnet, path)
    tnet = ModelSerializer.restore(path, device="cpu")
    assert tnet.num_params() == 25_557_032
    assert_same_state(tnet, jnet)
    bridged = cg_params_from_jax(ResNet50(input_shape=(3, 64, 64)).init(device="cpu"),
                                 jax.tree.map(np.asarray, jnet.params_),
                                 jax.tree.map(np.asarray, jnet.bn_state))
    x = np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32)
    out = tnet.output(x)[0]
    assert torch.isfinite(out).all() and out.max() < 0.5
    assert torch.equal(out, bridged.output(x)[0])


def test_updater_state_is_optional_and_a_normalizer_is_ignored(tmp_path):
    jnet = jax_net("lenet")
    _train(jnet, "lenet", True)
    path = str(tmp_path / "m.zip")
    JMS.write_model(jnet, path)
    with zipfile.ZipFile(path, "a") as z:  # what write_model(normalizer=...) adds
        z.writestr("normalizer.json", '{"@class": "NormalizerStandardize"}')
    full = ModelSerializer.restore(path, device="cpu")
    assert_same_state(full, jnet)
    fresh = ModelSerializer.restore(path, load_updater=False, device="cpu")
    assert all(not t.any() for slot in fresh.updater_state.values() for t in slot.values())
    for (_, _, a), (_, _, b) in zip(fresh._param_entries(), full._param_entries()):
        assert torch.equal(a, b)
    # write_model(normalizer=) is ported: it adds the normalizer's JSON, which a
    # restore ignores (tests/test_torch_normalizers.py holds it to JAX's)
    from deeplearning4j_tpu_torch.data.normalizers import ImagePreProcessingScaler

    npath = str(tmp_path / "n.zip")
    ModelSerializer.write_model(full, npath, normalizer=ImagePreProcessingScaler())
    with zipfile.ZipFile(npath) as z:
        assert json.loads(z.read("normalizer.json"))["kind"] == "image"
    assert_same_state(ModelSerializer.restore(npath, device="cpu"), jnet)


def test_model_guesser(tmp_path):
    tnet = port_net("char_rnn")
    path = str(tmp_path / "m.zip")
    ModelSerializer.writeModel(tnet, path)
    guessed = ModelGuesser.load_model_guess(path, device="cpu")
    for (_, _, a), (_, _, b) in zip(guessed._param_entries(), tnet._param_entries()):
        assert torch.equal(a, b)
    foreign = tmp_path / "k.keras"
    with zipfile.ZipFile(foreign, "w") as z:
        z.writestr("config.json", "{}")
    with pytest.raises(ValueError, match="configuration.json"):
        ModelGuesser.loadModelGuess(str(foreign))
    for name, magic in (("m.h5", b"\x89HDF\r\n\x1a\n"), ("g.pb", b"\x0a\x05nodes")):
        (tmp_path / name).write_bytes(magic + b"\0" * 32)
        with pytest.raises(NotImplementedError, match="item 8.8"):
            ModelGuesser.load_model_guess(str(tmp_path / name))
    (tmp_path / "x.bin").write_bytes(b"PK nothing")
    with pytest.raises(ValueError, match="cannot guess"):
        ModelGuesser.load_model_guess(str(tmp_path / "x.bin"))
