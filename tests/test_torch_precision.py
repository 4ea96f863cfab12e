"""Port parity: ``common.environment``, ``common.dtypes`` and
``common.precision`` of ``deeplearning4j_tpu_torch`` against the JAX
package's, on the CPU. Every comparison is exact (names, flags, dtypes).

What the policy means on CUDA, pinned below: ``auto`` resolves by the
device the work runs on. The JAX package asks its default backend (bf16 on
any accelerator, float32 on the CPU); the port asks the device it is given,
``"cuda"`` by default as for every entry point, so ``compute_dtype("cuda")``
is bf16 and ``compute_dtype("cpu")`` is float32 (no card is probed, so the
answer is the same on a host without one). ``tf32`` is float32, as in the
reference, and asking the policy never flips
``torch.backends.cuda.matmul.allow_tf32``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import dtypes as JD
from deeplearning4j_tpu.common import environment as JE
from deeplearning4j_tpu.common import precision as JP
from deeplearning4j_tpu_torch.common import dtypes as TD
from deeplearning4j_tpu_torch.common import environment as TE
from deeplearning4j_tpu_torch.common import precision as TP
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

POLICIES = ["auto", "bf16", "bfloat16", "float32", "highest", "tf32", "AUTO", "BF16"]


def _name(dtype) -> str:
    return str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else jnp.dtype(dtype).name


# ------------------------------------------------------------------ dtypes


def test_data_type_members_and_predicates_match_jax():
    assert [(m.name, m.value) for m in TD.DataType] == [(m.name, m.value) for m in JD.DataType]
    for t in TD.DataType:
        j = JD.DataType[t.name]
        assert (t.is_fp(), t.is_int(), t.is_signed(), t.width) == (
            j.is_fp(), j.is_int(), j.is_signed(), j.width), t
        assert _name(t.torch) == jnp.dtype(j.jax).name
        assert repr(t) == repr(j)
        if t is TD.DataType.BFLOAT16:
            with pytest.raises(TypeError, match="bfloat16"):
                t.np
        else:
            assert t.np == np.dtype(j.np)


def test_promote_types_matches_jax_over_all_pairs():
    for a, b in itertools.product(TD.DataType, repeat=2):
        want = JD.promote_types(JD.DataType[a.name], JD.DataType[b.name])
        assert TD.promote_types(a, b).name == want.name, (a, b)
    assert TD.promote_types(TD.DataType.HALF, TD.DataType.BFLOAT16) is TD.DataType.FLOAT


def test_to_torch_and_from_torch():
    for t in TD.DataType:
        assert TD.to_torch(t) is t.torch
        assert TD.to_torch(t.name.lower()) is t.torch
        assert TD.to_torch(t.value) is t.torch
        assert TD.from_torch(t.torch) is t
        assert TD.from_torch(TD.to_torch(t)).name == JD.from_jax(JD.to_jax(t.name)).name
    assert TD.to_torch(np.float16) is torch.float16
    assert TD.to_torch(torch.int8) is torch.int8
    for bad in (torch.complex64, "float8", np.complex128):
        with pytest.raises(TypeError):
            TD.from_torch(bad) if isinstance(bad, torch.dtype) else TD.to_torch(bad)


# ------------------------------------------------------------- environment


def test_environment_parses_tdl_flags_like_jax(monkeypatch):
    for name, value in (("TDL_VERBOSE", "yes"), ("TDL_CHECK_NAN", "0"),
                        ("TDL_MATMUL_PRECISION", "tf32"), ("TDL_MAX_HOST_THREADS", "7"),
                        ("TDL_SEED", "42"), ("TDL_DEFAULT_FLOAT", "bfloat16"),
                        ("TDL_EAGER_CACHE_SIZE", "16")):
        monkeypatch.setenv(name, value)
    port, ref = TE.Environment(), JE.Environment()
    assert port.dump() == ref.dump()
    assert port.dump()["seed"] == 42 and port.verbose is True and port.check_nan is False
    monkeypatch.delenv("TDL_SEED")
    assert TE.Environment().dump() == JE.Environment().dump()
    with pytest.raises(KeyError, match="unknown flag"):
        port.set("no_such_flag", 1)
    with pytest.raises(AttributeError):
        port.no_such_flag
    assert TE.host_cpu_count() == JE.host_cpu_count() >= 1


def test_the_port_singleton_is_its_own():
    port, ref = TE.env(), JE.env()
    assert TE.env() is port and TE.Environment.get_instance() is port
    before = ref.matmul_precision
    old = port.matmul_precision
    try:
        port.set("matmul_precision", "bf16" if before != "bf16" else "float32")
        assert ref.matmul_precision == before
    finally:
        port.set("matmul_precision", old)


# --------------------------------------------------------------- precision


@pytest.fixture
def policy():
    """Set both packages' policy to one value; restores both afterwards."""
    old = (TE.env().matmul_precision, JE.env().matmul_precision)

    def set_(value):
        TE.env().set("matmul_precision", value)
        JE.env().set("matmul_precision", value)

    yield set_
    TE.env().set("matmul_precision", old[0])
    JE.env().set("matmul_precision", old[1])


@pytest.mark.parametrize("value", POLICIES)
def test_cpu_policy_matches_jax_on_the_cpu(value, policy):
    policy(value)
    assert jax.default_backend() == "cpu"
    assert _name(TP.compute_dtype("cpu")) == jnp.dtype(JP.compute_dtype()).name
    for model in ("float32", "bfloat16", "float64"):
        assert TP.amp_enabled(getattr(torch, model), "cpu") == JP.amp_enabled(
            getattr(jnp, model)), model


@pytest.mark.parametrize("value", POLICIES)
def test_cuda_policy_matches_jax_on_an_accelerator(value, policy, monkeypatch):
    """JAX's answer on a non-CPU backend (its backend check patched to
    "gpu") is the port's for work on "cuda", which is also the default."""
    policy(value)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    want = jnp.dtype(JP.compute_dtype()).name
    assert _name(TP.compute_dtype("cuda")) == want
    assert _name(TP.compute_dtype(torch.device("cuda", 0))) == want
    assert _name(TP.compute_dtype()) == want
    assert TP.amp_enabled() == JP.amp_enabled()
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


def test_auto_is_bf16_on_cuda_and_float32_on_the_cpu(policy):
    policy("auto")
    assert TP.compute_dtype() is torch.bfloat16
    assert TP.compute_dtype("cuda") is torch.bfloat16
    assert TP.compute_dtype("cpu") is torch.float32
    policy("tf32")
    assert TP.compute_dtype("cuda") is torch.float32


def test_cast_floating_and_cast_input_match_jax():
    rs = np.random.RandomState(0)
    tree = {"w": rs.randn(3, 2).astype(np.float32), "ids": np.arange(4, dtype=np.int32),
            "nested": [rs.randn(2).astype(np.float64), np.array([True, False])]}
    ref = JP.cast_floating(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    got = TP.cast_floating({"w": torch.from_numpy(tree["w"]),
                            "ids": torch.from_numpy(tree["ids"]),
                            "nested": [torch.from_numpy(tree["nested"][0]),
                                       torch.from_numpy(tree["nested"][1])]}, torch.bfloat16)
    assert _name(got["w"].dtype) == ref["w"].dtype.name == "bfloat16"
    assert _name(got["ids"].dtype) == ref["ids"].dtype.name == "int32"
    assert [_name(t.dtype) for t in got["nested"]] == [a.dtype.name for a in ref["nested"]]
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(ref["w"].astype(jnp.float32)))
    module = torch.nn.Linear(3, 2)
    cast = TP.cast_floating(module, torch.bfloat16)
    assert set(cast) == {"weight", "bias"} and cast["weight"].dtype == torch.bfloat16
    assert module.weight.dtype == torch.float32  # the module keeps its parameters
    assert TP.cast_input(None, torch.bfloat16) is None
    ids = np.arange(3)
    assert TP.cast_input(ids, torch.bfloat16) is ids
    x = TP.cast_input(rs.randn(2, 2).astype(np.float32), torch.float16)
    assert x.dtype == torch.float16
    assert JP.cast_input(ids, jnp.bfloat16) is ids
