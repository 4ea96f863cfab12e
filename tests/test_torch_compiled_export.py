"""Compiled-artifact export of the port (``serde.compiled``) against the JAX
package's, on the CPU.

Mirror of ``tests/test_compiled_export.py``: the flatten round trip with its
empty-container and tuple markers (keys equal to the JAX ``_flatten``'s), an
MLN with BatchNormalization after 3 fit steps carried across with
``mln_params_from_jax`` (the JAX artifact and the port's each reloaded,
agreeing within the JAX test's 1e-5 / 1e-6), the net without BN, the zip's
three names, ``weights.npz`` with the JAX artifact's keys and arrays bit for
bit (float32 and bfloat16), a reload in a subprocess that imports neither
JAX nor the port's ``nn``/``models``, and ``export_samediff`` refused.
"""

import io
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serde import compiled as JZ
from deeplearning4j_tpu_torch.serde.compiled import (CompiledModel, _flatten, _unflatten,
                                                     export_samediff, load_compiled)
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_mlp(bn=True, seed=3):
    from deeplearning4j_tpu.nn import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import (BatchNormalization, DenseLayer, InputType,
                                            OutputLayer)
    from deeplearning4j_tpu.nn.updaters import Adam

    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2)).list()
         .layer(DenseLayer(n_in=6, n_out=16, activation="relu")))
    if bn:
        b = b.layer(BatchNormalization())
    b = b.layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
    return MultiLayerNetwork(b.set_input_type(InputType.feed_forward(6)).build()).init()


def _trained_pair(bn=True):
    from deeplearning4j_tpu.data.dataset import DataSet

    jnet = _jax_mlp(bn)
    rs = np.random.RandomState(0)
    x = rs.randn(16, 6).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 16)]
    for _ in range(3):  # bn statistics and parameters away from their init
        jnet._fit_batch(DataSet(x, y))
    return jnet, port_net(jnet), x


def _npz(path):
    with zipfile.ZipFile(path) as z:
        with np.load(io.BytesIO(z.read("weights.npz"))) as npz:
            return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("compiled")
    jnet, tnet, x = _trained_pair()
    jpath, tpath = str(d / "jax.zip"), str(d / "port.zip")
    jnet.export(jpath, x)
    tnet.export(tpath, x)
    return jnet, tnet, x, jpath, tpath


def test_flatten_roundtrip_with_empty_containers_and_tuples():
    tree = {"a": {"b": np.ones((2,)), "c": np.zeros((3,))},
            "lst": [np.full((1,), 2.0), {"d": np.full((2, 2), 3.0)}],
            "empty": {}, "none": [], "tup": (np.ones(1), np.zeros(2))}
    flat = _flatten(tree)
    assert list(flat) == list(JZ._flatten(tree))
    back = _unflatten(flat)
    assert set(back) == {"a", "lst", "empty", "none", "tup"}
    assert back["empty"] == {} and back["none"] == [] and isinstance(back["tup"], tuple)
    np.testing.assert_array_equal(back["lst"][1]["d"], tree["lst"][1]["d"])


def test_mln_export_reload_matches_the_jax_artifact(artifacts):
    jnet, tnet, x, jpath, tpath = artifacts
    loaded = load_compiled(tpath, device="cpu")
    assert isinstance(loaded, CompiledModel)
    got = loaded(x)
    assert torch.equal(got, tnet.output(x))  # the program is output()'s forward
    want = np.asarray(JZ.load_compiled(jpath)(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.output(x).numpy()),
                               rtol=1e-5, atol=1e-6)
    meta = loaded.metadata
    assert meta["model_type"] == "MultiLayerNetwork"
    assert meta["producer"] == "deeplearning4j_tpu_torch"
    assert set(JZ.load_compiled(jpath).metadata) - {"producer"} <= set(meta)
    assert meta["device"] == "cpu" and meta["compute_dtype"] == "float32"


def test_export_without_batchnorm(tmp_path):
    """bn == {} survives the round trip: the empty dict is part of the
    program's calling convention."""
    _, tnet, x = _trained_pair(bn=False)
    p = str(tmp_path / "nobn.zip")
    tnet.export(p, x[:3])
    assert "bn/__EMPTY_DICT__" in _npz(p)
    got = load_compiled(p, device="cpu")(x[:3])
    np.testing.assert_allclose(got.numpy(), tnet.output(x[:3]).numpy(), rtol=1e-5, atol=1e-6)


def test_artifact_holds_exactly_three_names(artifacts):
    with zipfile.ZipFile(artifacts[4]) as z:
        assert set(z.namelist()) == {"model.pt2", "weights.npz", "metadata.json"}


def test_weights_npz_equals_the_jax_artifacts(artifacts):
    """Same keys, same dtypes, same bytes; and the program holds no copy of
    the weights (they are its inputs)."""
    jflat, tflat = _npz(artifacts[3]), _npz(artifacts[4])
    assert list(tflat) == list(jflat)
    for k in jflat:
        assert tflat[k].dtype == jflat[k].dtype and tflat[k].tobytes() == jflat[k].tobytes(), k
    program = load_compiled(artifacts[4], device="cpu")._program
    assert not program.state_dict and not program.constants


def test_bf16_weights_npz_equals_the_jax_artifacts(tmp_path):
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn import conf as JC
    from deeplearning4j_tpu.nn import updaters as JU
    from deeplearning4j_tpu_torch.models.weights import mln_params_from_jax
    from deeplearning4j_tpu_torch.nn import conf as TC
    from deeplearning4j_tpu_torch.nn import updaters as TU
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from torch_ckpt_helpers import bf16_conf

    jnet = JMLN(bf16_conf(JC, JU)).init()
    tnet = mln_params_from_jax(MultiLayerNetwork(bf16_conf(TC, TU), device="cpu").init(),
                               jax.tree.map(np.asarray, jnet.params_))
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    jnet.export(str(tmp_path / "j.zip"), x)
    tnet.export(str(tmp_path / "t.zip"), x)
    jflat, tflat = _npz(tmp_path / "j.zip"), _npz(tmp_path / "t.zip")
    assert list(tflat) == list(jflat)
    assert {str(a.dtype) for k, a in tflat.items() if k.startswith("params/")} == {"|V2"}
    for k in jflat:
        assert tflat[k].dtype == jflat[k].dtype and tflat[k].tobytes() == jflat[k].tobytes(), k
    got = load_compiled(str(tmp_path / "t.zip"), device="cpu")(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, tnet.output(x))


def test_reload_in_a_subprocess_without_jax_or_the_model_classes(artifacts, tmp_path):
    _, tnet, x, _, tpath = artifacts
    np.save(tmp_path / "x.npy", x)
    script = (
        "import sys, numpy as np, torch\n"
        "from deeplearning4j_tpu_torch.serde.compiled import load_compiled\n"
        f"m = load_compiled({tpath!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, m(np.load({str(tmp_path / 'x.npy')!r})).numpy())\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
        "'deeplearning4j_tpu') or k.startswith(('deeplearning4j_tpu_torch.nn', "
        "'deeplearning4j_tpu_torch.models'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", script], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert torch.equal(torch.from_numpy(np.load(tmp_path / "y.npy")), tnet.output(x))


def test_export_samediff_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 8"):
        export_samediff(None, "x.zip", {}, ["out"])
