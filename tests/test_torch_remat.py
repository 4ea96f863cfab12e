"""Port parity: per-block remat (``TransformerConfig.remat``) in
``deeplearning4j_tpu_torch.models.transformer``, on the CPU.

Tiny model: 2 layers, d 32, 4 heads, float32 compute; inputs from numpy
seeds. Tolerances:
- remat against no remat in the port: 1e-6 (loss relative, each gradient
  element within 1e-6 of its tensor's largest entry); both run the same
  ops, so only the recompute's sums in another order could part them;
- against the JAX package: the loss 1e-5 relative and the gradients
  atol 1e-6 + rtol 1e-4, as ``tests/test_torch_train.py`` holds the step
  without remat.

The reference's own ``encode`` with ``remat=True`` raises: it wraps
``_block`` in ``jax.checkpoint`` with ``static_argnums=()``, so the Python
bool ``train`` becomes a tracer that ``_dropout`` cannot branch on. The JAX
side below therefore checkpoints ``_block`` itself with ``train`` static,
which is what the reference's remat computes once that argument is marked
static.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import params_from_jax
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

REMAT_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4

_SMALL = dict(vocab_size=97, max_len=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _cfgs(**kw):
    kw = {"dropout": 0.1, **_SMALL, **kw}
    return (J.TransformerConfig(compute_dtype=jnp.float32, **kw),
            T.TransformerConfig(compute_dtype=torch.float32, **kw))


def _models(jc, tc, seed=0):
    jp = J.init_params(jax.random.key(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _batch(seed=1, B=2, L=19, P=5, vocab=97):
    rs = np.random.RandomState(seed)
    return {
        "tokens": rs.randint(0, vocab, (B, L)).astype(np.int32),
        "pad_mask": (np.arange(L)[None] < rs.randint(L // 2, L + 1, B)[:, None]
                     ).astype(np.float32),
        "mlm_positions": np.stack([np.sort(rs.choice(L, P, replace=False))
                                   for _ in range(B)]).astype(np.int32),
        "labels": rs.randint(0, vocab, (B, P)).astype(np.int32),
        "weights": np.ones((B, P), np.float32),
    }


def _flat(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same(got, ref, atol_of_max):
    assert set(got) == set(ref)
    for name, r in ref.items():
        r = r.numpy() if isinstance(r, torch.Tensor) else r
        tol = atol_of_max * max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(got[name].numpy(), r, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_with_a_real_generator_gives_the_same_step(impl):
    """A real seeded generator and dropout 0.1: remat and no remat give the
    same loss, the same gradients, and leave the generator in the same
    state. Without the generator state put back for the recompute, the
    backward would use other masks and the gradients would differ."""
    _, tc = _cfgs(attn_impl=impl)
    _, tp = _models(*_cfgs(attn_impl=impl))
    batch = _batch()
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    loss, grads = T.loss_and_grads(tp, batch, tc, gens[0])
    rloss, rgrads = T.loss_and_grads(tp, batch, dataclasses.replace(tc, remat=True), gens[1])
    np.testing.assert_allclose(rloss.item(), loss.item(), rtol=REMAT_TOL)
    _assert_same(rgrads, grads, REMAT_TOL)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # dropout did act: a step without it differs
    _, plain = T.loss_and_grads(tp, batch, dataclasses.replace(tc, dropout=0.0))
    assert (plain["blocks.0.qkv_w"] - grads["blocks.0.qkv_w"]).abs().max() > 1e-4


def test_remat_recompute_without_the_generator_state_would_differ(monkeypatch):
    """The failure the design guards against is real: a plain checkpoint,
    whose recompute draws from the generator as it stands, gives other
    gradients."""
    _, tc = _cfgs()
    _, tp = _models(*_cfgs())
    batch = _batch(seed=2)
    loss, grads = T.loss_and_grads(tp, batch, tc, torch.Generator().manual_seed(3))

    def naive(cfg, p, h, pad_mask, generator, train):
        return T.checkpoint(T._block, cfg, p, h, pad_mask, generator, train,
                            use_reentrant=False)

    monkeypatch.setattr(T, "_remat_block", naive)
    _, bad = T.loss_and_grads(tp, batch, dataclasses.replace(tc, remat=True),
                              torch.Generator().manual_seed(3))
    worst = max((bad[n] - g).abs().max().item() / g.abs().max().item()
                for n, g in grads.items() if g.abs().max() > 0)
    assert worst > 1e-3


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    _, tc = _cfgs(dropout=0.0)
    _, tp = _models(*_cfgs(dropout=0.0))
    calls = []
    block = T._block
    monkeypatch.setattr(T, "_block", lambda *a, **k: calls.append(1) or block(*a, **k))
    T.loss_and_grads(tp, _batch(), tc)
    assert len(calls) == tc.n_layers
    calls.clear()
    T.loss_and_grads(tp, _batch(), dataclasses.replace(tc, remat=True))
    assert len(calls) == 2 * tc.n_layers
    calls.clear()
    T.forward(tp, _batch()["tokens"], dataclasses.replace(tc, remat=True))  # serving
    assert len(calls) == tc.n_layers


def _masks(B, L, seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(B, L, _SMALL["d_model"]) > 0.1 for _ in range(2 * _SMALL["n_layers"])]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_gradients_match_jax_remat(impl, monkeypatch):
    """The same numpy masks go into both packages' dropout. JAX takes them
    in call order. The port's patched ``dropout_mask`` keys each mask on a
    number it draws from the generator, so the recompute of a block, which
    sees the generator's state of the block's first run, gets that run's
    masks again (and a recompute from another state would ask for a mask
    past the last one)."""
    jc, tc = _cfgs(attn_impl=impl, remat=True)
    jp, tp = _models(jc, tc, seed=4)
    batch = _batch(seed=5)
    masks = _masks(2, 19, 6)
    jmasks, tmasks = iter(masks), iter(masks)
    by_draw = {}

    def jax_bernoulli(key, p, shape):
        return jnp.asarray(next(jmasks))

    def torch_mask(generator, keep, shape, device):
        draw = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        if draw not in by_draw:
            by_draw[draw] = torch.from_numpy(next(tmasks))
        assert by_draw[draw].shape == tuple(shape)
        return by_draw[draw]

    with pytest.raises(jax.errors.ConcretizationTypeError):
        J.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jc, jax.random.key(0), True)

    def jax_loss(params, b, rng):
        h = J.embed(params, b["tokens"], jc)
        for i, p in enumerate(params["blocks"]):
            # a function object per layer: jax.checkpoint caches its trace
            # per function and shapes, and a shared one would reuse layer
            # 0's masks in layer 1
            block = jax.checkpoint(functools.partial(J._block, jc), static_argnums=(4,))
            h = block(p, h, b["pad_mask"], jax.random.fold_in(rng, i), True)
        logits = J.mlm_head(params, h, jc, positions=b["mlm_positions"])
        return J.token_ce_loss(logits, b["labels"], b["weights"])

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(T, "dropout_mask", torch_mask)
    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(jp, jax.tree.map(jnp.asarray, batch),
                                                       jax.random.key(0))
    loss, grads = T.loss_and_grads(tp, batch, tc, torch.Generator().manual_seed(7))
    assert next(jmasks, None) is None and next(tmasks, None) is None
    assert len(by_draw) == len(masks)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    ref = _flat(ref_grads)
    assert set(grads) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), r, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
