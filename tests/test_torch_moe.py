"""The port's Mixture-of-Experts FFN (``deeplearning4j_tpu_torch.models.moe``)
against the JAX package's ``models/moe.py`` on the same numpy inputs and
weights (JAX's ``init_moe_params`` through ``moe_params_from_jax``).

Tolerances: float32 outputs, aux loss and gradients within 1e-5 (of the
largest magnitude for outputs and gradients: sums over a few hundred
products in another order); bf16 inputs within 2e-2 of the largest output
magnitude (bf16 keeps 8 bits; the routing itself runs in float32 in both
packages and is compared exactly). The expert-parallel form runs on four
gloo CPU ranks, ``{"data": 2, "expert": 2}``, and is held to JAX's
unsharded ``moe_ffn`` on the global batch, with a capacity that drops
token-slots among the cases.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import moe as J
from deeplearning4j_tpu_torch.models import moe as T
from deeplearning4j_tpu_torch.models.weights import moe_params_from_jax
from deeplearning4j_tpu_torch.parallel import launcher
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

F32_REL = 1e-5
BF16_REL = 2e-2
WORKERS = os.path.join(os.path.dirname(__file__), "torch_moe_workers.py")


def _params(E, D, F, seed):
    """``init_moe_params``' shapes and scale, drawn with numpy (biases
    nonzero, so that they are checked too)."""
    rs = np.random.RandomState(seed)
    draw = lambda *shape, s=0.02: (rs.randn(*shape) * s).astype(np.float32)  # noqa: E731
    return {"wg": draw(D, E, s=0.5), "w1": draw(E, D, F, s=0.3), "b1": draw(E, F),
            "w2": draw(E, F, D, s=0.3), "b2": draw(E, D)}


def _setup(E=4, k=2, cap=4.0, D=8, F=16, shape=(2, 6), seed=0):
    cfg = dict(d_model=D, d_ff=F, n_experts=E, top_k=k, capacity_factor=cap)
    x = np.random.RandomState(seed + 1).randn(*shape, D).astype(np.float32)
    return cfg, _params(E, D, F, seed), x


def _jax_ffn(cfg):
    jcfg = J.MoEConfig(**cfg)
    return jax.jit(lambda p, x: J.moe_ffn(p, x, jcfg))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _both(cfg, params, x, dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jy, jaux = _jax_ffn(cfg)(params, jnp.asarray(x, jdt))
    ty, taux = T.moe_ffn(moe_params_from_jax(params, device="cpu"),
                         torch.from_numpy(x).to(dtype), T.MoEConfig(**cfg))
    return (np.asarray(jy.astype(jnp.float32)), float(jaux),
            ty.detach().float().numpy(), float(taux))


@pytest.mark.parametrize("case", [
    dict(),                                  # _setup's shapes
    dict(E=3, k=1, cap=100.0),               # top-1 uncapped: dense expert choice
    dict(E=2, k=1, cap=0.26),                # a capacity that drops tokens
    dict(E=8, k=2, cap=1.25, D=16, F=32, shape=(4, 8)),
])
def test_moe_ffn_equals_jax(case):
    cfg, params, x = _setup(**case)
    jy, jaux, ty, taux = _both(cfg, params, x)
    assert ty.shape == jy.shape == x.shape
    assert _rel(ty, jy) <= F32_REL
    assert abs(taux - jaux) <= F32_REL * abs(jaux)
    if case.get("cap") == 0.26:
        dropped = np.all(ty.reshape(-1, x.shape[-1]) == 0.0, axis=-1)
        assert dropped.sum() > 0
        np.testing.assert_array_equal(dropped, np.all(jy.reshape(-1, x.shape[-1]) == 0.0, -1))


def test_bf16_input_routes_in_float32_as_jax():
    cfg, params, x = _setup(E=4, k=2, cap=1.0, shape=(2, 8))
    jy, jaux, ty, taux = _both(cfg, params, x, torch.bfloat16)
    assert _rel(ty, jy) <= BF16_REL
    assert abs(taux - jaux) <= BF16_REL * abs(jaux)
    # the routing (which slots are kept, and where) is JAX's exactly
    jg = np.asarray(jax.nn.softmax(jnp.asarray(x, jnp.bfloat16).reshape(-1, 8)
                                   @ jnp.asarray(params["wg"], jnp.bfloat16), axis=-1))
    tg = torch.softmax(torch.from_numpy(x).bfloat16().reshape(-1, 8)
                       @ torch.from_numpy(params["wg"]).bfloat16(), dim=-1)
    C = J.MoEConfig(**cfg).capacity(16)
    jd = J._topk_dispatch(jnp.asarray(jg), 2, C)[1]
    td = T._topk_dispatch(tg, 2, C)[1]
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_gradients_of_every_parameter_equal_jax():
    cfg, params, x = _setup(E=4, k=2, cap=1.0, shape=(3, 5))
    jcfg, tcfg = J.MoEConfig(**cfg), T.MoEConfig(**cfg)

    def jloss(p):
        y, aux = J.moe_ffn(p, jnp.asarray(x), jcfg)
        return jnp.sum(y * y) + 0.01 * aux

    jgrads = jax.jit(jax.grad(jloss))(params)
    tparams = moe_params_from_jax(params, device="cpu")
    y, aux = T.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    loss = torch.sum(y * y) + 0.01 * aux
    tgrads = dict(zip(tparams, torch.autograd.grad(loss, list(tparams.values()))))
    for name in params:
        assert _rel(tgrads[name].numpy(), jgrads[name]) <= F32_REL, name
    assert np.abs(np.asarray(jgrads["wg"])).max() > 0


def test_ties_in_the_router_go_to_the_lower_expert_as_jax_top_k():
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0]], np.float32)
    for k in (1, 2, 3):
        jc, jd, _ = J._topk_dispatch(jnp.asarray(gates), k, 4)
        tc, td, _, _ = T._topk_dispatch(torch.from_numpy(gates), k, 4)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-7)


def test_capacity_and_specs_equal_jax():
    for k, n, cf, e in ((2, 12, 4.0, 4), (1, 12, 0.26, 2), (2, 2048, 1.25, 8), (2, 7, 1.0, 3),
                        (1, 1, 0.01, 8), (2, 640, 0.5, 8)):
        kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
        assert T.MoEConfig(**kw).capacity(n) == J.MoEConfig(**kw).capacity(n)
    jspecs = J.moe_partition_specs(J.MoEConfig())
    assert {k: tuple(v) for k, v in T.moe_partition_specs(T.MoEConfig()).items()} == \
        {k: tuple(v) for k, v in jspecs.items()}


def test_init_and_the_bridge():
    jp = jax.tree.map(np.asarray, J.init_moe_params(jax.random.key(0), J.MoEConfig(8, 16, 4)))
    tp = moe_params_from_jax(jp, device="cpu")
    assert all(np.array_equal(tp[k].detach().numpy(), jp[k]) for k in jp)
    cfg = T.MoEConfig(d_model=8, d_ff=16, n_experts=4)
    p = T.init_moe_params(3, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wg": (8, 4), "w1": (4, 8, 16), "b1": (4, 16), "w2": (4, 16, 8), "b2": (4, 8)}
    assert all(v.requires_grad for v in p.values())
    q = T.init_moe_params(3, cfg, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)  # a seed gives the same weights
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_moe_params(3, cfg)
    with pytest.raises(KeyError):
        moe_params_from_jax({"wg": np.zeros((8, 4))}, device="cpu")


EP_CASES = {
    "fits": dict(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=4.0),
    "drops": dict(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=0.5),
    "drops_most": dict(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=0.3),
}


def _kept_slots(params, x, cfg, halves):
    """Kept token-slots per token of JAX's routing: on the whole batch, or
    (``halves``) as a per-rank routing would keep them, each data half with
    its own capacity and cumsum."""
    jcfg = J.MoEConfig(**cfg)
    xt = x.reshape(-1, x.shape[-1])
    parts = np.split(xt, 2) if halves else [xt]
    out = []
    for part in parts:
        gates = jax.nn.softmax(jnp.asarray(part) @ params["wg"], axis=-1)
        dispatch = J._topk_dispatch(gates, jcfg.top_k, jcfg.capacity(len(part)))[1]
        out.append(np.asarray(dispatch).sum(axis=(1, 2)))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def expert_parallel_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    out = {}
    for i, (name, cfg) in enumerate(EP_CASES.items()):
        jcfg = J.MoEConfig(**cfg)
        params = _params(cfg["n_experts"], cfg["d_model"], cfg["d_ff"], 10 + i)
        x = np.random.RandomState(20 + i).randn(4, 8, cfg["d_model"]).astype(np.float32)

        def jloss(p, x, jcfg=jcfg):
            y, aux = J.moe_ffn(p, x, jcfg)
            return jnp.sum(y * y) + 0.01 * aux, (y, aux)

        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, x)
        np.savez(d / f"{name}.npz", x=x, **params)
        out[name] = {"y": np.asarray(y), "aux": float(aux),
                     "grads": jax.tree.map(np.asarray, grads),
                     "kept": _kept_slots(params, x, cfg, False),
                     "kept_per_rank": _kept_slots(params, x, cfg, True)}
    (d / "cases.json").write_text(json.dumps(EP_CASES))
    results = launcher.launch(f"{WORKERS}:run_cases", n_processes=4, platform="cpu",
                              extra_env={"TDL_MP_DIR": str(d), "OMP_NUM_THREADS": "1"},
                              timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"
    for name in EP_CASES:
        out[name]["ranks"] = [dict(np.load(d / f"{name}.rank{r}.npz")) for r in range(4)]
    return out


@pytest.mark.parametrize("name", list(EP_CASES))
def test_expert_parallel_equals_jax_unsharded(expert_parallel_runs, name):
    run = expert_parallel_runs[name]
    ranks = run["ranks"]
    # rank r = (data r // 2, expert r % 2): the data rows of ranks 0 and 2
    y = np.concatenate([ranks[0]["y"], ranks[2]["y"]])
    assert _rel(y, run["y"]) <= F32_REL
    for r in (1, 3):  # the expert axis's ranks hold the same rows
        np.testing.assert_allclose(ranks[r]["y"], ranks[r - 1]["y"], rtol=0, atol=1e-6)
    for rk in ranks:
        assert abs(float(rk["aux"]) - run["aux"]) <= F32_REL * abs(run["aux"])
        for k, want in run["grads"].items():
            assert _rel(rk[f"g_{k}"], want) <= F32_REL, (name, k)
    if name.startswith("drops"):
        # the capacity drops token-slots, and a per-rank capacity or cumsum
        # would have kept others (so y would differ)
        assert run["kept"].sum() < EP_CASES[name]["top_k"] * len(run["kept"])
        assert not np.array_equal(run["kept"], run["kept_per_rank"])
