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
ZOO = ("VGG16", "VGG19", "AlexNet", "Darknet19", "SqueezeNet", "UNet", "Xception", "NASNet")


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
        "models = importlib.import_module('deeplearning4j_tpu_torch.models')\n"
        f"assert all(n in models.__all__ and hasattr(models, n) for n in {ZOO!r})\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deeplearning4j_tpu_torch.models.transformer" in added
    assert "deeplearning4j_tpu_torch.kernels._build" in added
    assert {f"deeplearning4j_tpu_torch.nn.{m}" for m in ("layers_ext", "layers_tail",
                                                        "capsules")} <= set(added)
    assert "deeplearning4j_tpu_torch.nn.updaters" in added
    for module in ("common.environment", "common.dtypes", "common.precision",
                   "kernels.autotune", "nn.activations", "nn.weights", "nn.losses",
                   "nn.dropout", "nn.constraints", "nn.conf", "nn.attention_layers",
                   "data.dataset", "data.iterators", "data.datasets", "eval.evaluation",
                   "nn.multilayer", "models.zoo", "models.text_lstm", "models.weights",
                   "nn.graph_conf", "nn.graph", "models.resnet", "models.facenet",
                   "common.faults", "common.compile_cache", "parallel.inference",
                   "monitoring.registry", "monitoring.flight", "monitoring.history",
                   "monitoring.aggregate", "monitoring.timeline", "monitoring.serving",
                   "monitoring.heartbeat", "monitoring.alerts", "serving.executor",
                   "serving.json_server", "serving.loadgen", "serving.pool",
                   "common.durability", "serde.checkpoint", "serde.net_state",
                   "serde.model_serializer", "listeners.listeners", "nn.earlystopping",
                   "kernels.attention", "serde.compiled", "common.data_parallel",
                   "monitoring.trace", "parallel.mesh", "parallel.collectives",
                   "parallel.compression", "parallel.launcher", "parallel.trainer",
                   "parallel.wrapper", "parallel.sharding", "parallel.partition",
                   "monitoring.partition", "parallel.pipeline", "monitoring.costmodel",
                   "parallel.supervisor", "monitoring.deploy", "deploy", "deploy.controller",
                   "nlp", "nlp.tokenization", "nlp.vocab", "nlp.word2vec", "nlp.word_vectors",
                   "nlp.sequencevectors", "nlp.paragraph_vectors", "nlp.glove", "nlp.tfidf",
                   "nlp.tsne", "nlp.bert_iterator", "arbiter", "arbiter.optimize",
                   "arbiter.spaces", "arbiter.trial_worker", "arbiter.fleet", "monitoring.trial",
                   "nn.transfer", "models.vgg", "models.zoo_ext", "models.nasnet",
                   "common.bucketing", "data.normalizers", "data.records",
                   "data.record_reader_iterator", "data.image", "data.etl_service",
                   "monitoring.etl", "data.transform", "data.audio", "ops", "ops.profiler",
                   "monitoring.watchdogs", "monitoring.compilecache", "monitoring.listener",
                   "monitoring.slo", "common.debug", "utils"):
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
    parameters on ``device``, "cuda" unless the caller asks for the CPU; so
    does a BatchNormalization layer's running state."""
    _no_card()
    from deeplearning4j_tpu_torch import models
    from deeplearning4j_tpu_torch.models import (InceptionResNetV1, LeNet, ResNet50,
                                                 TextGenerationLSTM)
    from deeplearning4j_tpu_torch.nn import (BatchNormalization, ComputationGraph, InputType,
                                             MultiLayerNetwork)

    calls = {"MultiLayerNetwork": lambda: MultiLayerNetwork(LeNet().conf()),
             "LeNet().init()": lambda: LeNet().init(),
             "TextGenerationLSTM().init()": lambda: TextGenerationLSTM().init(),
             "ComputationGraph": lambda: ComputationGraph(ResNet50().conf()),
             "ResNet50().init()": lambda: ResNet50().init(),
             "InceptionResNetV1().init()": lambda: InceptionResNetV1().init(),
             **{f"{n}().init()": (lambda n=n: getattr(models, n)().init()) for n in ZOO},
             "BatchNormalization().init_state": lambda: BatchNormalization().init_state(
                 InputType.feed_forward(4))}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert next(LeNet().init(device="cpu").parameters()).device.type == "cpu"
    state = BatchNormalization().init_state(InputType.feed_forward(4), device="cpu")
    assert {t.device.type for t in state.values()} == {"cpu"}


def test_distributed_and_export_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """``launcher.initialize`` and ``launch`` (platform ``cuda`` and backend
    ``nccl`` unless asked for the CPU), ``load_compiled`` (the card unless
    given ``device``), the trainers, sharded or not (their network's
    device), ``place_params``, ``PipelineParallelTrainer`` and
    ``pipeline_net`` (the card unless given ``device``) raise on a host with
    no card before any process starts or any store binds."""
    _no_card()
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer, launcher
    from deeplearning4j_tpu_torch.serde.compiled import export_compiled, load_compiled

    for name in ("TDL_PLATFORM", "TDL_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TDL_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TDL_NUM_PROCESSES", "1")
    monkeypatch.setenv("TDL_PROCESS_ID", "0")
    path = str(tmp_path / "m.zip")
    export_compiled(lambda w, x: x * w["s"], (torch.ones(2),), {"s": torch.ones(())}, path)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    from deeplearning4j_tpu_torch.parallel.partition import PipelinePartitioner, SpecLayout
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallelTrainer, pipeline_net

    kw = dict(vocab_size=32, max_len=8, d_model=8, n_heads=2, n_layers=1, d_ff=16)
    tree = jax.tree.map(np.asarray, J.init_params(jax.random.key(0), J.TransformerConfig(**kw)))
    calls = {"launcher.initialize": lambda: launcher.initialize(),
             "launcher.launch": lambda: launcher.launch("x:y", 1),
             "load_compiled": lambda: load_compiled(path),
             "ParallelTrainer": lambda: ParallelTrainer(MultiLayerNetwork(LeNet().conf())),
             "ParallelTrainer(mesh_layout=)": lambda: ParallelTrainer(
                 MultiLayerNetwork(LeNet().conf()), mesh_layout=SpecLayout(1, 1, 1)),
             "place_params": lambda: T.place_params(
                 tree, T.TransformerConfig(**kw), Mesh.virtual({"dp": 1, "tp": 1, "sp": 1}, 0)),
             "PipelineParallelTrainer": lambda: PipelineParallelTrainer(
                 tree, T.TransformerConfig(**kw, dropout=0.0), Adam(),
                 PipelinePartitioner(SpecLayout(data=1, fsdp=1, pipe=2), mesh=Mesh.virtual(
                     {"pipe": 2, "data": 1, "fsdp": 1, "tp": 1}, 0)), n_microbatches=2),
             "pipeline_net": lambda: pipeline_net(tree, Adam())}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert load_compiled(path, device="cpu")(torch.full((2,), 3.0)).tolist() == [3.0, 3.0]


def test_nlp_trainers_default_to_cuda():
    """``Word2Vec``, ``ParagraphVectors``, ``Glove``, ``SequenceVectors`` and
    ``BarnesHutTsne`` (and their builders) target the card unless given
    ``device``; on a host with no card their fits and ``infer_vector`` raise
    before any training."""
    from deeplearning4j_tpu_torch import nlp
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
    from deeplearning4j_tpu_torch.nlp.tsne import BarnesHutTsne

    sents = ["cat dog cat", "car bus car", "dog cat dog"]
    docs = [("a", sents[0]), ("b", sents[1])]
    walks = nlp.AbstractSequenceIterator.from_token_lists([s.split() for s in sents])
    trainers = {
        "Word2Vec": (nlp.Word2Vec(), lambda m: m.fit(sents)),
        "Word2Vec.Builder": (nlp.Word2Vec.Builder().iterate(sents).build(), lambda m: m.fit()),
        "ParagraphVectors": (ParagraphVectors(), lambda m: m.fit(docs)),
        "ParagraphVectors.Builder": (ParagraphVectors.Builder().iterate(docs).build(),
                                     lambda m: m.fit()),
        "Glove": (Glove(), lambda m: m.fit(sents)),
        "Glove.Builder": (Glove.Builder().iterate(sents).build(), lambda m: m.fit()),
        "SequenceVectors": (nlp.SequenceVectors(), lambda m: m.fit(walks)),
        "SequenceVectors.Builder": (nlp.SequenceVectors.Builder().iterate(walks).build(),
                                    lambda m: m.fit()),
        "BarnesHutTsne": (BarnesHutTsne(), lambda m: m.fit_transform(np.eye(6, 3))),
        "BarnesHutTsne.Builder": (BarnesHutTsne.Builder().build(),
                                  lambda m: m.fit_transform(np.eye(6, 3))),
    }
    for name, (model, fit) in trainers.items():
        assert model.device == "cuda", name
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                fit(model)
    if not torch.cuda.is_available():
        pv = ParagraphVectors(layer_size=4, epochs=1, device="cpu").fit(docs)
        pv.device = "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            pv.infer_vector("cat dog")


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


def test_input_pipeline_host_modules_import_without_torch():
    """What a spawned ETL worker imports (``data.etl_service`` with the
    image, record, dataset and iterator modules, through the lazy ``data``
    package), the normalizers and the bucketing policy load in a fresh
    interpreter without torch, JAX or the JAX package."""
    script = ("import json, sys\n"
              "from deeplearning4j_tpu_torch.data import ImageEtlSpec, EtlDataSetIterator\n"
              "import deeplearning4j_tpu_torch.data.etl_service\n"
              "import deeplearning4j_tpu_torch.data.image\n"
              "import deeplearning4j_tpu_torch.data.record_reader_iterator\n"
              "import deeplearning4j_tpu_torch.data.normalizers\n"
              "import deeplearning4j_tpu_torch.common.bucketing\n"
              "import deeplearning4j_tpu_torch.monitoring.etl\n"
              "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in mods if _forbidden(m)] == []
    assert "torch" not in mods and "deeplearning4j_tpu_torch.data.etl_service" in mods


def test_supervisor_and_controller_import_without_jax_or_torch():
    """``parallel.supervisor``, ``deploy.controller`` and ``monitoring.deploy``
    load in a fresh interpreter without JAX, the JAX package, or torch: a
    supervisor or a controller process holds no tensor."""
    script = ("import json, sys\n"
              "import deeplearning4j_tpu_torch.parallel.supervisor\n"
              "import deeplearning4j_tpu_torch.deploy.controller\n"
              "import deeplearning4j_tpu_torch.monitoring.deploy\n"
              "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in mods if _forbidden(m)] == []
    assert "torch" not in mods
    assert "deeplearning4j_tpu_torch.deploy.controller" in mods


def test_supervisor_controller_and_canary_replica_default_to_cuda(tmp_path):
    """The gang supervisor spawns on the card unless asked for the CPU (and
    raises here before any process starts); the controller's ``main`` takes
    its eval target's device, the card by default, so the eval gate fails
    on the card's error instead of scoring on the CPU; a pool's canary
    replica built on the default device never becomes ready here."""
    _no_card()
    from deeplearning4j_tpu_torch.deploy.controller import main
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import GangSupervisor
    from deeplearning4j_tpu_torch.serde import TrainingCheckpointer
    from deeplearning4j_tpu_torch.serving import ServingPool
    from torch_pool_workers import mln_net

    workers = ROOT / "tests" / "torch_controller_workers.py"
    sup = GangSupervisor(f"{workers}:eval_sleepy", n_processes=2,
                         workdir=str(tmp_path / "gang"), registry=MetricsRegistry())
    assert sup.platform == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        sup.run(timeout=30.0)
    ck = tmp_path / "ck"
    TrainingCheckpointer(str(ck), async_write=False).save(mln_net())
    cfg = {"ckpt_dir": str(ck), "workdir": str(tmp_path / "deploy"),
           "gates": ["integrity", "eval"], "retries": 0,
           "eval_target": f"{workers}:eval_on_default_device"}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    assert main([str(tmp_path / "c.json"), "--once"]) == 0
    state = json.loads((tmp_path / "deploy" / "controller_state.json").read_text())
    (cand,) = state["candidates"].values()
    assert cand["rejected_by"] == {"gate": "eval", "reason": "error:RuntimeError"}
    assert "cuda" in cand["verdicts"][-1]["evidence"]["error"]
    pool = ServingPool(f"{workers}:default_device_server", replicas=1,
                       workdir=str(tmp_path / "pool"), registry=MetricsRegistry(),
                       restart_backoff_base=5.0).start()
    try:
        with pytest.raises(TimeoutError, match="never became ready"):
            pool.start_canary(str(ck), ready_timeout=60.0)
    finally:
        pool.stop()
    logs = "".join(p.read_text() for p in (tmp_path / "pool").rglob("*.log"))
    assert "RuntimeError" in logs and "cuda" in logs


def test_fleet_cli_loads_no_jax():
    """``python -m deeplearning4j_tpu_torch.arbiter.fleet`` (here asked for
    its usage) runs in an interpreter that never loads JAX or the JAX
    package, and neither does a trial gang's worker module."""
    script = ("import json, runpy, sys\n"
              "sys.argv = ['fleet', '--help']\n"
              "try:\n"
              "    runpy.run_module('deeplearning4j_tpu_torch.arbiter.fleet', "
              "run_name='__main__')\n"
              "except SystemExit as e:\n"
              "    assert e.code == 0, e.code\n"
              "import deeplearning4j_tpu_torch.arbiter.trial_worker\n"
              "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert "PBT/ASHA trial fleet" in out.stdout
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deeplearning4j_tpu_torch.arbiter.fleet" in mods
    assert [m for m in mods if _forbidden(m)] == []


def test_trial_gangs_default_to_cuda_and_raise_without_a_card(tmp_path):
    """``GangTrialRunner`` and ``from_config`` run their gangs on the card
    unless asked for the CPU; on a host with no card a gang raises before
    any process starts (a sweep of such gangs quarantines every trial and
    names no winner). ``lenet_images`` builds over the ETL service."""
    _no_card()
    from deeplearning4j_tpu_torch.arbiter import fleet as F
    from deeplearning4j_tpu_torch.arbiter.trial_worker import build_task
    from deeplearning4j_tpu_torch.monitoring import MetricsRegistry

    runner = F.GangTrialRunner(str(tmp_path / "sweep"))
    assert runner.platform == "cuda"
    slot = F.TrialSlot("t00", {"learning_rate": 0.01, "hidden": 8}, str(tmp_path / "t00"),
                       str(tmp_path / "t00" / "ckpt"))
    with pytest.raises(RuntimeError, match="cuda"):
        runner(slot, 1, 30.0)
    assert not list(tmp_path.rglob("rank0.err"))  # no worker was started
    cfg = {"workdir": str(tmp_path / "cfg"), "n_trials": 2, "rungs": [1],
           "trial_max_restarts": 0, "backoff_base_s": 0.01,
           "spaces": {"learning_rate": {"kind": "continuous", "lo": 1e-3, "hi": 1e-1}}}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    fleet = F.from_config(str(tmp_path / "c.json"))
    fleet.registry = MetricsRegistry()
    try:
        assert fleet.runner.platform == "cuda"
        with pytest.raises(RuntimeError, match="no surviving"):
            fleet.run()
    finally:
        fleet.close()
    assert {t.quarantine_reason for t in fleet.trials.values()} == {"crash_budget"}
    from PIL import Image

    for i in range(4):
        (tmp_path / "imgs" / f"c{i % 2}").mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.full((16, 16), 40 * i, np.uint8), mode="L").save(
            tmp_path / "imgs" / f"c{i % 2}" / f"i{i}.png")
    task = build_task({"kind": "lenet_images", "data_dir": str(tmp_path / "imgs"),
                       "height": 12, "width": 12, "batch": 2, "store_pad": 2})
    assert (task.spec.num_classes, task.num_batches) == (2, 2)


def test_model_tail_and_rl_default_to_cuda_and_raise_without_a_card(tmp_path):
    """The MoE parameters, the VAE, TinyYOLO, the HF import and the
    reinforcement learners place their tensors on ``device``, "cuda" unless
    the caller asks for the CPU."""
    _no_card()
    from deeplearning4j_tpu_torch.models import (MoEConfig, TinyYOLO, VariationalAutoencoder,
                                                 init_moe_params)
    from deeplearning4j_tpu_torch.models.bert_import import import_hf_bert
    from deeplearning4j_tpu_torch.rl import (CartPoleEnv, DQNFactoryStdDense, GymEnvAdapter,
                                             QLearningDiscrete)
    from deeplearning4j_tpu_torch.rl.actor_critic import (A2CVectorized, A3CConfiguration,
                                                          A3CDiscrete, init_actor_critic)
    from deeplearning4j_tpu_torch.rl.history import AsyncNStepQLearningDiscrete

    cfg = {"vocab_size": 8, "max_position_embeddings": 4, "hidden_size": 4,
           "num_attention_heads": 1, "num_hidden_layers": 0, "intermediate_size": 4}
    sd = {"embeddings.word_embeddings.weight": np.zeros((8, 4), np.float32),
          "embeddings.position_embeddings.weight": np.zeros((4, 4), np.float32),
          "embeddings.token_type_embeddings.weight": np.zeros((2, 4), np.float32),
          "embeddings.LayerNorm.weight": np.ones(4, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(4, np.float32)}
    env = lambda *a: GymEnvAdapter(CartPoleEnv(0))  # noqa: E731
    calls = {"init_moe_params": lambda: init_moe_params(0, MoEConfig(8, 16, 2)),
             "VariationalAutoencoder": lambda: VariationalAutoencoder(6),
             "TinyYOLO().init()": lambda: TinyYOLO(input_shape=(3, 32, 32)).init(),
             "import_hf_bert": lambda: import_hf_bert(sd, config=cfg),
             "DQNFactoryStdDense.build": lambda: DQNFactoryStdDense.build(4, 2),
             "QLearningDiscrete": lambda: QLearningDiscrete(env()),
             "AsyncNStepQLearningDiscrete": lambda: AsyncNStepQLearningDiscrete(env),
             "init_actor_critic": lambda: init_actor_critic(0, 4, 2),
             "A3CDiscrete": lambda: A3CDiscrete(env, A3CConfiguration(), 4, 2),
             "A2CVectorized": lambda: A2CVectorized(env, A3CConfiguration(), 4, 2)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    model, _ = import_hf_bert(sd, config=cfg, device="cpu")
    assert model.device.type == "cpu"


def test_every_port_test_module_takes_the_per_process_leak_audit():
    """A port test module that imports JAX runs under ``tests/conftest.py``,
    whose leak audit reads the machine's whole /dev/shm: under ``-n 6`` it
    blames (and unlinks) the rings that ``test_etl_service.py`` holds in
    another worker, and the port test ERRORs at teardown though its body
    passed. So each such module takes ``torch_port_fixtures``' per-process
    audit of the same name."""
    missing = []
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        src = path.read_text()
        if "import jax" in src and "from torch_port_fixtures import _no_leaked_children_or_shm" \
                not in src:
            missing.append(path.name)
    assert missing == []
