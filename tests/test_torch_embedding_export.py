"""Port parity: compiled export (``MultiLayerNetwork.export``) of networks
with an EmbeddingLayer or an EmbeddingSequenceLayer, against the JAX
package's artifact of the same network, on the CPU.

``torch.export`` cannot trace the eager id check's branch on the ids'
values, so the traced program maps an id as JAX's exported gather does (a
negative id counted once from the end, then clamped into range); the eager
path still raises on an out-of-range id. Each network is exported from both
packages (the port's holding the JAX network's weights), the port's
artifact reloaded in a subprocess without the model classes, and the
outputs held within the export test's rtol 1e-5 / atol 1e-6;
``weights.npz`` has the JAX artifact's keys (a Bidirectional's directions
nested as JAX nests them).
"""

import io
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serde import compiled as JZ
from test_torch_nn_layers_ext_rnn import V, _batch, _embedding_ff, _text_rnn
from torch_mln_helpers import port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_compiled_export.py's


def _keys(path):
    with zipfile.ZipFile(path) as z:
        with np.load(io.BytesIO(z.read("weights.npz"))) as npz:
            return sorted(npz.files)


@pytest.mark.parametrize("name", ["embedding_ff", "text_rnn"])
def test_embedding_networks_export_and_reload_like_jax(name, tmp_path):
    build = {"embedding_ff": _embedding_ff, "text_rnn": _text_rnn}[name]
    jnet = JNet(build(JC, JU)).init()
    tnet = port_net(jnet)
    x, _ = _batch(name, np.random.RandomState(0))
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jnet.export(jpath, x)
    tnet.export(tpath, x)
    assert _keys(tpath) == _keys(jpath)
    want = np.asarray(JZ.load_compiled(jpath)(x))
    np.save(tmp_path / "x.npy", x)
    script = (
        "import sys, numpy as np\n"
        "from deeplearning4j_tpu_torch.serde.compiled import load_compiled\n"
        f"m = load_compiled({tpath!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, m(np.load({str(tmp_path / 'x.npy')!r})).numpy())\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
        "'deeplearning4j_tpu') or k.startswith(('deeplearning4j_tpu_torch.nn', "
        "'deeplearning4j_tpu_torch.models'))]\n"
        "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", script], env=dict(os.environ, PYTHONPATH=ROOT),
                       cwd=str(tmp_path), capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    got = np.load(tmp_path / "y.npy")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, tnet.output(x).numpy(), rtol=RTOL, atol=ATOL)


def test_out_of_range_ids_raise_eagerly_and_clamp_in_the_program(tmp_path):
    """Eager ``output()`` refuses an id past the table (a CUDA gather there
    would poison the context); the exported program, traced on valid ids,
    clamps it as JAX's artifact does and gives JAX's answer."""
    jnet = JNet(_embedding_ff(JC, JU)).init()
    tnet = port_net(jnet)
    x, _ = _batch("embedding_ff", np.random.RandomState(1))
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jnet.export(jpath, x)
    tnet.export(tpath, x)
    bad = x.copy()
    bad[0, 0], bad[1, 0], bad[2, 0] = V + 3, -2, -V - 4
    with pytest.raises(ValueError, match="embedding ids"):
        tnet.output(bad)
    from deeplearning4j_tpu_torch.serde.compiled import load_compiled

    got = load_compiled(tpath, device="cpu")(bad).numpy()
    np.testing.assert_allclose(got, np.asarray(JZ.load_compiled(jpath)(bad)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[3:], tnet.output(x[3:]).numpy(), rtol=RTOL, atol=ATOL)
    assert torch.compiler.is_exporting() is False
