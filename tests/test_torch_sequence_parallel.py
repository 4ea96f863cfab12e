"""Sequence- and tensor-parallel attention and the flagship's sharded train
step, held to the JAX package.

Gloo gangs on the CPU (workers in ``tests/torch_sharded_workers.py``,
``sequence_parallel``), one of 2 ranks and one of 4:

- ``ring_attention`` and ``ulysses_attention`` on each rank's sequence
  shard, causal and not, with and without a key mask, against the JAX
  package's functions under ``shard_map`` over as many CPU devices: the
  output within 2e-5, the gradients of q, k and v under one cotangent
  within 1e-4 + 1e-4 of the reference (the kernel limits of PERF.md §2);
- the small flagship (d_model 64, 4 heads, 2 layers, d_ff 128, vocab 256,
  T 32, float32 compute) placed on a 4-rank (dp, tp, sp) mesh by
  ``place_params``, one Adam step of ``make_train_step`` on the global batch
  at (1, 2, 2) with Ulysses, (2, 1, 2) with ring, (2, 2, 1) with dense
  attention, and at (1, 2, 2) with dropout 0.1 on injected masks, against
  JAX's single-device ``make_train_step``: the loss within 2e-5 relative,
  every gathered gradient and updated leaf within 1e-4 of its norm.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.common import jax_compat
from deeplearning4j_tpu.kernels import attention as JA
from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.parallel import launcher
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

WORKERS = os.path.join(os.path.dirname(__file__), "torch_sharded_workers.py")
ENV = {"TDL_MATMUL_PRECISION": "float32", "OMP_NUM_THREADS": "1"}
OUT_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
LOSS_REL = 2e-5
LEAF_REL = 1e-4
SMALL = dict(vocab_size=256, max_len=32, d_model=64, n_heads=4, n_layers=2, d_ff=128)
B, L, P = 4, 32, 6

ATTN = [(impl, causal, masked) for impl in ("ring", "ulysses") for causal in (False, True)
        for masked in (False, True)]
FLAGSHIP = {"ulysses_122": ((1, 2, 2), "ulysses", "sp", 0.0),
            "ring_212": ((2, 1, 2), "ring", "sp", 0.0),
            "dense_221": ((2, 2, 1), "xla", None, 0.0),
            "ulysses_122_dropout": ((1, 2, 2), "ulysses", "sp", 0.1)}


def _attn_name(world, impl, causal, masked):
    return f"attn{world}_{impl}_{'causal' if causal else 'full'}_{'mask' if masked else 'nomask'}"


def _attn_arrays(world, seed):
    rs = np.random.RandomState(seed)
    Bq, H, Tg, D = 2, 4, 8 * world, 8
    q, k, v, cot = (rs.randn(Bq, H, Tg, D).astype(np.float32) for _ in range(4))
    mask = (rs.rand(Bq, Tg) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0  # every row keeps a live key, causal or not
    return {"q": q, "k": k, "v": v, "cot": cot, "mask": mask}


def _jax_attention(a, world, impl, causal, masked):
    """JAX's ring/Ulysses under shard_map over ``world`` CPU devices: the
    output and the gradients of q, k, v under the cotangent."""
    mesh = JMesh(np.asarray(jax.devices()[:world]), ("sp",))
    fn = JA.ring_attention if impl == "ring" else JA.ulysses_attention
    spec = JP(None, None, "sp", None)
    if masked:
        f = jax_compat.shard_map(
            lambda q, k, v, m: fn(q, k, v, axis_name="sp", causal=causal, key_mask=m),
            mesh=mesh, in_specs=(spec, spec, spec, JP(None, "sp")), out_specs=spec)
        run = lambda q, k, v: f(q, k, v, jnp.asarray(a["mask"]))  # noqa: E731
    else:
        run = jax_compat.shard_map(
            lambda q, k, v: fn(q, k, v, axis_name="sp", causal=causal),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)

    @jax.jit
    def out_and_grads(q, k, v, cot):
        out, vjp = jax.vjp(run, q, k, v)
        return out, vjp(cot)

    out, grads = out_and_grads(*(jnp.asarray(a[n]) for n in ("q", "k", "v", "cot")))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _cfgs(attn_impl, sequence_axis, dropout):
    kw = dict(SMALL, dropout=dropout, attn_impl=attn_impl)
    jc = J.TransformerConfig(compute_dtype=jnp.float32, **{**kw, "attn_impl": "xla"})
    tc = T.TransformerConfig(compute_dtype=torch.float32, sequence_axis=sequence_axis, **kw)
    return jc, tc


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {
        "tokens": rs.randint(0, SMALL["vocab_size"], (B, L)).astype(np.int32),
        "segments": (np.arange(L)[None] >= L // 2).repeat(B, 0).astype(np.int32),
        "pad_mask": (np.arange(L)[None] < rs.randint(L // 2, L + 1, B)[:, None]
                     ).astype(np.float32),
        "mlm_positions": np.stack([np.sort(rs.choice(L, P, replace=False))
                                   for _ in range(B)]).astype(np.int32),
        "labels": rs.randint(0, SMALL["vocab_size"], (B, P)).astype(np.int32),
        "weights": (rs.rand(B, P) > 0.2).astype(np.float32),
    }


def _flat(tree, prefix):
    out = {}
    for top, sub in tree.items():
        if top == "blocks":
            for i, blk in enumerate(sub):
                out.update({f"{prefix}/blocks/{i}/{k}": np.asarray(v) for k, v in blk.items()})
        else:
            out.update({f"{prefix}/{top}/{k}": np.asarray(v) for k, v in sub.items()})
    return out


def _jax_step(params, batch, jc, masks):
    """JAX's single-device loss, gradients and one Adam step (dropout masks
    fed in call order where given)."""
    feed = iter(list(masks) * 2)
    orig = jax.random.bernoulli
    if masks:
        jax.random.bernoulli = lambda key, p, shape: jnp.asarray(next(feed))
    try:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        upd = JU.Adam(1e-3)
        step = J.make_train_step(jc, upd)

        @jax.jit
        def run(p, b):
            loss, grads = jax.value_and_grad(J.loss_fn)(p, b, jc, jax.random.key(0), True)
            new, _, _ = step(p, upd.init(p), b, jnp.asarray(0, jnp.int32), jax.random.key(0))
            return loss, grads, new

        loss, grads, new = run(params, jb)
    finally:
        jax.random.bernoulli = orig
    return float(loss), _flat(jax.tree.map(np.asarray, grads), "g"), _flat(
        jax.tree.map(np.asarray, new), "p")


def _launch(d, world):
    results = launcher.launch(f"{WORKERS}:sequence_parallel", n_processes=world,
                              platform="cpu", extra_env={**ENV, "TDL_MP_DIR": str(d)},
                              timeout=300)
    for r in results:
        assert r.returncode == 0, f"rank {r.rank} failed:\n{r.stderr[-3000:]}"


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The 2-rank gang (attention) and the 4-rank gang (attention and the
    flagship); returns the references and each rank's results."""
    refs = {}
    dirs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"seqpar{world}")
        dirs[world] = d
        cases = []
        for i, (impl, causal, masked) in enumerate(ATTN):
            name = _attn_name(world, impl, causal, masked)
            a = _attn_arrays(world, 100 * world + i)
            if not masked:
                del a["mask"]
            np.savez(d / f"{name}.npz", **a)
            cases.append({"name": name, "kind": "attention", "world": world, "impl": impl,
                          "causal": causal})
            refs[name] = _jax_attention(a, world, impl, causal, masked)
        if world == 4:
            for j, (name, (mesh, impl, axis, dropout)) in enumerate(FLAGSHIP.items()):
                jc, tc = _cfgs(impl, axis, dropout)
                params = J.init_params(jax.random.key(j), jc)
                batch = _batch(50 + j)
                rs = np.random.RandomState(70 + j)
                masks = ([rs.rand(B, L, SMALL["d_model"]) > dropout
                          for _ in range(2 * SMALL["n_layers"])] if dropout else [])
                arrays = {**_flat(jax.tree.map(np.asarray, params), "p"),
                          **{f"b/{k}": v for k, v in batch.items()},
                          **{f"mask{i}": m for i, m in enumerate(masks)}}
                np.savez(d / f"{name}.npz", **arrays)
                cases.append({"name": name, "kind": "flagship", "mesh": list(mesh),
                              "cfg": {k: getattr(tc, k) for k in
                                      (*SMALL, "dropout", "attn_impl", "sequence_axis")}})
                refs[name] = (_jax_step(params, batch, jc, masks),
                              _flat(jax.tree.map(np.asarray, params), "p"))
        (d / "cases.json").write_text(json.dumps(cases))
        _launch(d, world)
    return refs, dirs


def _ranks(dirs, world, name):
    return [dict(np.load(dirs[world] / f"{name}.rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("impl,causal,masked", ATTN)
def test_sequence_parallel_attention_matches_jax_shard_map(gangs, world, impl, causal, masked):
    refs, dirs = gangs
    name = _attn_name(world, impl, causal, masked)
    out, grads = refs[name]
    ranks = _ranks(dirs, world, name)
    got = {k: np.concatenate([r[k] for r in ranks], axis=2) for k in ("out", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["out"], out, rtol=0, atol=OUT_ATOL)
    for n, want in zip("qkv", grads):
        np.testing.assert_allclose(got[f"d{n}"], want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"d{n}")


def _leaf_err(got, want, before=None):
    g = got.astype(np.float64) - (0 if before is None else before)
    w = want.astype(np.float64) - (0 if before is None else before)
    n = np.linalg.norm(w)
    return np.linalg.norm(g - w) / (n if n > 0 else 1.0)


@pytest.mark.parametrize("name", list(FLAGSHIP))
def test_flagship_sharded_step_matches_jax_single_device(gangs, name):
    refs, dirs = gangs
    (loss, grads, new), before = refs[name]
    ranks = _ranks(dirs, 4, name)
    for r in ranks:
        assert abs(float(r["loss"]) - loss) <= LOSS_REL * abs(loss)
        assert abs(float(r["step_loss"]) - loss) <= LOSS_REL * abs(loss)
    got = ranks[0]
    for k, want in grads.items():
        assert _leaf_err(got[k], want) <= LEAF_REL, f"gradient {k}"
    for k, want in new.items():
        # the update (new - old) against JAX's, of its norm
        assert _leaf_err(got[k], want, before[k].astype(np.float64)) <= LEAF_REL, f"leaf {k}"
    # at rest each rank holds its blocks: a leaf split over tp is 1/tp of it
    # (sp and dp replicate parameters), three times over (parameters, Adam's
    # m and v)
    tp = FLAGSHIP[name][0][1]
    specs = T._flat_specs(_cfgs(*FLAGSHIP[name][1:])[1])
    want = 3 * sum(v.nbytes // (tp if "tp" in specs[k[2:].replace("/", ".")] else 1)
                   for k, v in before.items())
    assert [int(r["held"]) for r in ranks] == [want] * 4
