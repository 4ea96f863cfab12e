"""The port stands alone: it imports neither JAX nor the JAX package, builds
its CUDA kernels only with nvcc, and never runs quietly on the CPU.

- a fresh interpreter imports every module of ``deeplearning4j_tpu_torch``
  and must not gain ``jax`` or ``deeplearning4j_tpu`` in ``sys.modules``;
- an AST scan of the port and of ``chip_smoke.py`` finds no such import;
- entry points called without ``device`` target CUDA, so on a host with no
  GPU they raise instead of running on the CPU.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu_torch.common.device import resolve_device
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import attention as TA
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import params_from_jax, qa_params_from_jax
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_importing_the_port_loads_no_jax():
    script = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deeplearning4j_tpu_torch.models.transformer" in added
    assert "deeplearning4j_tpu_torch.kernels._build" in added
    assert "deeplearning4j_tpu_torch.nn.updaters" in added
    for module in ("common.environment", "common.dtypes", "common.precision",
                   "kernels.autotune", "nn.activations", "nn.weights", "nn.losses",
                   "nn.dropout", "nn.constraints", "nn.conf", "nn.attention_layers",
                   "data.dataset", "data.iterators", "data.datasets", "eval.evaluation",
                   "nn.multilayer", "models.zoo", "models.text_lstm", "models.weights",
                   "nn.graph_conf", "nn.graph", "models.resnet", "models.facenet"):
        assert f"deeplearning4j_tpu_torch.{module}" in added
    assert [m for m in added if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_jax_import_in_the_source(path):
    tree = ast.parse((ROOT / path).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m)] == []


def test_cuda_sources_are_plain_c_interfaces():
    """Route (b): nvcc into a shared library bound with ctypes; no source
    pulls in PyTorch's headers (which would take minutes to compile)."""
    sources = _build.sources()
    assert [s.name for s in sources] == ["flash_bwd.cu", "flash_fwd.cu"]
    for src in sources:
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text
        assert 'extern "C"' in text
    cmd = _build.nvcc_command("nvcc", sources[0], Path("out.so"))
    for flag in ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-fPIC"):
        assert flag in cmd
    assert _build.build_dir().name == "kernels"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("TDL_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this host has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert list(tmp_path.iterdir()) == []


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    def no_build(stem):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "library", no_build)
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 16, 8).astype(np.float32)) for _ in range(3))
    before = TA.flash_forward.launches
    out = TA.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), TA.mha_reference(q, k, v, causal=True).numpy(),
                               atol=2e-5)
    assert TA.flash_forward.launches == before


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    cfg = T.TransformerConfig(vocab_size=97, max_len=64, d_model=32, n_heads=4, n_layers=2,
                              d_ff=64, causal=True, compute_dtype=torch.float32)
    jcfg = J.TransformerConfig(vocab_size=97, max_len=64, d_model=32, n_heads=4, n_layers=2,
                               d_ff=64, causal=True, compute_dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, J.init_params(jax.random.key(0), jcfg))
    qa_tree = jax.tree.map(np.asarray, J.init_qa_head(jax.random.key(1), jcfg))
    cpu_params = T.init_params(0, cfg, device="cpu")
    calls = {
        "resolve_device": lambda: resolve_device(),
        "init_params": lambda: T.init_params(0, cfg),
        "Transformer": lambda: T.Transformer(cfg),
        "init_qa_head": lambda: T.init_qa_head(0, cfg),
        "QaHead": lambda: T.QaHead(cfg),
        "params_from_jax": lambda: params_from_jax(tree, cfg),
        "qa_params_from_jax": lambda: qa_params_from_jax(qa_tree, cfg),
        "init_kv_cache": lambda: T.init_kv_cache(cfg, 2),
        "DecodeSlotPool": lambda: T.DecodeSlotPool(cpu_params, cfg, slots=2),
        "PagedDecodeSlotPool": lambda: T.PagedDecodeSlotPool(cpu_params, cfg, slots=2),
        "generate": lambda: T.generate(cpu_params, [[1, 2, 3]], 2, cfg),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


def test_networks_default_to_cuda_and_raise_without_a_card():
    """MultiLayerNetwork, ComputationGraph and the zoo models place their
    parameters on ``device``, "cuda" unless the caller asks for the CPU."""
    _no_card()
    from deeplearning4j_tpu_torch.models import (InceptionResNetV1, LeNet, ResNet50,
                                                 TextGenerationLSTM)
    from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork

    calls = {"MultiLayerNetwork": lambda: MultiLayerNetwork(LeNet().conf()),
             "LeNet().init()": lambda: LeNet().init(),
             "TextGenerationLSTM().init()": lambda: TextGenerationLSTM().init(),
             "ComputationGraph": lambda: ComputationGraph(ResNet50().conf()),
             "ResNet50().init()": lambda: ResNet50().init(),
             "InceptionResNetV1().init()": lambda: InceptionResNetV1().init()}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert next(LeNet().init(device="cpu").parameters()).device.type == "cpu"


def test_cpu_training_never_touches_the_build(monkeypatch):
    """Gradients of CPU tensors come from the plain backward: no kernel is
    built, loaded or counted, through flash_attention and through a whole
    train step of the transformer."""
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    def no_build(stem):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "library", no_build)
    counters = (TA.flash_forward, TA.flash_backward_dkv, TA.flash_backward_dq)
    before = [f.launches for f in counters]
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 16, 8).astype(np.float32)).requires_grad_()
               for _ in range(3))
    grads = torch.autograd.grad(TA.flash_attention(q, k, v, causal=True).sum(), (q, k, v))
    assert all(torch.isfinite(g).all() for g in grads)
    cfg = T.TransformerConfig(vocab_size=97, max_len=32, d_model=32, n_heads=4, n_layers=1,
                              d_ff=64, dropout=0.1, attn_impl="flash",
                              compute_dtype=torch.float32)
    params = T.init_params(0, cfg, device="cpu")
    batch = {"tokens": rs.randint(0, 97, (2, 16)), "labels": rs.randint(0, 97, (2, 16))}
    updater = Adam(1e-3)
    _, _, loss = T.make_train_step(cfg, updater)(params, updater.init(params), batch, 0,
                                                 torch.Generator().manual_seed(0))
    assert loss.device.type == "cpu" and bool(torch.isfinite(loss))
    assert [f.launches for f in counters] == before
