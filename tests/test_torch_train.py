"""Port parity: the training path of ``deeplearning4j_tpu_torch`` (losses,
gradients, dropout, Adam, the train steps) against the JAX package, through
the weight bridge.

Small model: 2 layers, d 32, 4 heads, vocab 97, float32 compute; inputs and
noise from numpy seeds. JAX's flash attention runs its Pallas kernels in
interpret mode here; the port's runs its plain versions (CPU tensors).

Tolerances (float32 throughout; the two frameworks sum in other orders):
- loss: 1e-5 relative;
- gradients: atol 1e-6 + rtol 1e-4 per element (gradients are O(1e-2);
  the largest difference seen is a few 1e-8);
- Adam: rtol 1e-5 on updates and moments (alpha is float32 on both sides;
  the two compute m / (sqrt(v) + eps) * alpha in another order), plus an
  atol of 1e-6 of the tensor's largest entry for entries where
  b1 * m + (1 - b1) * g cancels to near zero;
- the 10-step loss curve: rtol 1e-4 (differences compound through the
  updates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import (params_from_jax, params_to_numpy,
                                                     qa_params_from_jax, updater_state_from_jax,
                                                     updater_state_to_numpy)
from deeplearning4j_tpu_torch.nn import updaters as TU
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
ADAM_RTOL = 1e-5
ADAM_SCALE_ATOL = 1e-6
CURVE_RTOL = 1e-4

_SMALL = dict(vocab_size=97, max_len=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _cfgs(**kw):
    kw = {"dropout": 0.0, **_SMALL, **kw}
    return (J.TransformerConfig(compute_dtype=jnp.float32, **kw),
            T.TransformerConfig(compute_dtype=torch.float32, **kw))


def _models(jc, tc, seed=0):
    jp = J.init_params(jax.random.key(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _batch(seed=1, B=2, L=19, P=5, vocab=97, positions=True):
    """A ragged MLM batch: every example keeps its first L//2 tokens, so no
    row is left without a live key (causal or not)."""
    rs = np.random.RandomState(seed)
    batch = {
        "tokens": rs.randint(0, vocab, (B, L)).astype(np.int32),
        "segments": (np.arange(L)[None] >= L // 2).repeat(B, 0).astype(np.int32),
        "pad_mask": (np.arange(L)[None] < rs.randint(L // 2, L + 1, B)[:, None]
                     ).astype(np.float32),
    }
    width = P if positions else L
    if positions:
        batch["mlm_positions"] = np.stack([np.sort(rs.choice(L, P, replace=False))
                                           for _ in range(B)]).astype(np.int32)
    batch["labels"] = rs.randint(0, vocab, (B, width)).astype(np.int32)
    batch["weights"] = (rs.rand(B, width) > 0.2).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(port: dict, ref: dict, atol, rtol, scale_atol=0.0):
    """Each entry within atol + rtol * |ref|, where atol is at least
    ``scale_atol`` times the tensor's largest |entry|."""
    assert set(port) == set(ref)
    for name, r in ref.items():
        g = port[name]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        tol = max(atol, scale_atol * float(np.abs(r).max()) if r.size else 0.0)
        np.testing.assert_allclose(g, r, atol=tol, rtol=rtol, err_msg=name)


# (attn_impl, norm_position, causal, with mlm_positions): every option of
# each axis appears with each impl
LOSS_CASES = [(impl, norm, causal, pos) for impl in ("xla", "flash")
              for norm, causal, pos in (("pre", False, True), ("post", True, True),
                                        ("pre", True, False), ("post", False, False))]


@pytest.mark.parametrize("impl,norm,causal,positions", LOSS_CASES)
def test_loss_and_grads_match_jax(impl, norm, causal, positions):
    jc, tc = _cfgs(attn_impl=impl, norm_position=norm, causal=causal)
    jp, tp = _models(jc, tc)
    batch = _batch(positions=positions)
    ref_loss, ref_grads = jax.value_and_grad(J.loss_fn)(jp, _jax_batch(batch), jc, None, True)
    loss, grads = T.loss_and_grads(tp, batch, tc)
    assert loss.dtype == torch.float32 and loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    assert all(g.dtype == torch.float32 for g in grads.values())
    _assert_tree_close(grads, _flat(ref_grads), GRAD_ATOL, GRAD_RTOL)
    # the gradients flowed through every parameter the loss uses
    assert grads["blocks.1.qkv_w"].abs().sum() > 0 and grads["mlm.w"].abs().sum() > 0


def test_token_ce_loss_matches_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(3, 7, 11).astype(np.float32) * 3
    labels = rs.randint(0, 11, (3, 7))
    weights = (rs.rand(3, 7) > 0.5).astype(np.float32)
    for w in (None, weights, np.zeros_like(weights)):
        ref = J.token_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                              None if w is None else jnp.asarray(w))
        out = T.token_ce_loss(torch.from_numpy(logits), labels, w)
        np.testing.assert_allclose(out.item(), float(ref), rtol=LOSS_RTOL, atol=1e-7)
    with pytest.raises(ValueError, match="label ids"):
        T.token_ce_loss(torch.from_numpy(logits), np.full((3, 7), 11))


def _jax_state(params, seed):
    """A nonzero Adam state shaped like the JAX params."""
    rs = np.random.RandomState(seed)
    return {"m": jax.tree.map(lambda p: jnp.asarray(rs.randn(*p.shape) * 1e-3, jnp.float32),
                              params),
            "v": jax.tree.map(lambda p: jnp.asarray(rs.rand(*p.shape) * 1e-5, jnp.float32),
                              params)}


def test_updater_state_bridge_round_trips_and_checks_names():
    jc, tc = _cfgs()
    jp, tp = _models(jc, tc)
    state = jax.tree.map(np.asarray, _jax_state(jp, 3))
    port = updater_state_from_jax(state, tp)
    assert set(port) == {"m", "v"} and set(port["m"]) == set(dict(tp.named_parameters()))
    assert port["v"]["blocks.0.ffn_w1"].dtype == torch.float32
    back = updater_state_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)
    assert updater_state_from_jax({}, tp) == {} and updater_state_to_numpy({}) == {}
    del state["m"]["mlm"]["b"]
    with pytest.raises(KeyError, match="mlm.b"):
        updater_state_from_jax(state, tp)


@pytest.mark.parametrize("schedule", [None, "warmup"])
def test_adam_apply_from_a_nonzero_state_matches_jax(schedule):
    jc, tc = _cfgs()
    jp, tp = _models(jc, tc)
    rs = np.random.RandomState(4)
    grads = jax.tree.map(lambda p: jnp.asarray(rs.randn(*p.shape) * 1e-2, jnp.float32), jp)
    state = _jax_state(jp, 5)
    warm = schedule == "warmup"
    jupd = JU.Adam(1e-3, lr_schedule=JU.WarmupLinearDecay(1e-3, 10, 100) if warm else None)
    tupd = TU.Adam(1e-3, lr_schedule=TU.WarmupLinearDecay(1e-3, 10, 100) if warm else None)
    ref_u, ref_s = jupd.apply(grads, state, jp, 4)
    t_state = updater_state_from_jax(jax.tree.map(np.asarray, state), tp)
    t_grads = {n: torch.from_numpy(v.copy()) for n, v in _flat(grads).items()}
    upd, new_state = tupd.apply(t_grads, t_state, tp, 4)
    assert new_state is t_state  # updated in place
    _assert_tree_close(upd, _flat(ref_u), 0, ADAM_RTOL, ADAM_SCALE_ATOL)
    _assert_tree_close(new_state["m"], _flat(ref_s["m"]), 0, ADAM_RTOL, ADAM_SCALE_ATOL)
    _assert_tree_close(new_state["v"], _flat(ref_s["v"]), 0, ADAM_RTOL, ADAM_SCALE_ATOL)


def test_updater_json_round_trip_matches_jax():
    for jup, tup in ((JU.Adam(1e-4), TU.Adam(1e-4)),
                     (JU.Sgd(0.5, lr_schedule=JU.WarmupLinearDecay(0.5, 3, 9)),
                      TU.Sgd(0.5, lr_schedule=TU.WarmupLinearDecay(0.5, 3, 9))),
                     (JU.NoOp(), TU.NoOp()),
                     (JU.Adam(1e-3, lr_schedule=JU.FixedSchedule(2e-3)),
                      TU.Adam(1e-3, lr_schedule=TU.FixedSchedule(2e-3)))):
        assert tup.to_json() == jup.to_json()
        assert TU.IUpdater.from_json(jup.to_json()) == tup
    for it in (0, 2, 3, 6, 9, 12):
        sched_j, sched_t = JU.WarmupLinearDecay(0.5, 3, 9), TU.WarmupLinearDecay(0.5, 3, 9)
        np.testing.assert_allclose(sched_t.value(it, 0), float(sched_j.value(it, 0)), rtol=1e-6)
    assert TU.get("adam", learning_rate=0.1) == TU.Adam(0.1)
    # every updater is ported now (tests/test_torch_updaters.py holds each)
    assert TU.IUpdater.from_json(JU.Nesterovs().to_json()) == TU.Nesterovs()


def test_sgd_and_noop_match_jax():
    jc, tc = _cfgs()
    jp, tp = _models(jc, tc)
    rs = np.random.RandomState(6)
    grads = jax.tree.map(lambda p: jnp.asarray(rs.randn(*p.shape), jnp.float32), jp)
    t_grads = {n: torch.from_numpy(v.copy()) for n, v in _flat(grads).items()}
    for jup, tup in ((JU.Sgd(0.3), TU.Sgd(0.3)), (JU.NoOp(), TU.NoOp())):
        ref, _ = jup.apply(grads, jup.init(jp), jp, 0)
        upd, state = tup.apply(t_grads, tup.init(tp), tp, 0)
        assert state == {}
        _assert_tree_close(upd, _flat(ref), 0, 1e-7)


def test_train_step_from_a_bridged_state_matches_jax():
    """One make_train_step step (Adam, flash attention) from a nonzero
    bridged state: loss, parameters and both moments."""
    jc, tc = _cfgs(attn_impl="flash")
    jp, tp = _models(jc, tc)
    batch = _batch(seed=8)
    state = _jax_state(jp, 9)
    t_state = updater_state_from_jax(jax.tree.map(np.asarray, state), tp)
    new_jp, new_js, ref_loss = J.make_train_step(jc, JU.Adam(1e-3))(
        jp, state, _jax_batch(batch), 3, None)
    params, t_state, loss = T.make_train_step(tc, TU.Adam(1e-3))(tp, t_state, batch, 3)
    assert params is tp
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    _assert_tree_close(dict(tp.named_parameters()), _flat(new_jp), 1e-7, 1e-6)
    _assert_tree_close(t_state["m"], _flat(new_js["m"]), 0, ADAM_RTOL, ADAM_SCALE_ATOL)
    _assert_tree_close(t_state["v"], _flat(new_js["v"]), 0, ADAM_RTOL, ADAM_SCALE_ATOL)


def test_ten_step_loss_curve_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _models(jc, tc, seed=10)
    batch = _batch(seed=11)
    updj, updt = JU.Adam(3e-3), TU.Adam(3e-3)
    jstate, tstate = updj.init(jp), updt.init(tp)
    jstep, tstep = J.make_train_step(jc, updj), T.make_train_step(tc, updt)
    jb = _jax_batch(batch)
    ref, got = [], []
    for it in range(10):
        jp, jstate, jl = jstep(jp, jstate, jb, it, None)
        tp, tstate, tl = tstep(tp, tstate, batch, it)
        ref.append(float(jl))
        got.append(tl.item())
    np.testing.assert_allclose(got, ref, rtol=CURVE_RTOL)
    assert got[-1] < got[0]
    _assert_tree_close(dict(tp.named_parameters()), _flat(jp), 1e-5, 1e-3)


def _qa_batch(seed=12, B=2, L=19):
    rs = np.random.RandomState(seed)
    tokens, pad = rs.randint(0, 97, (B, L)).astype(np.int32), np.ones((B, L), np.float32)
    pad[1, 15:] = 0.0
    return {"tokens": tokens, "pad_mask": pad,
            "segments": (np.arange(L)[None] >= 6).repeat(B, 0).astype(np.int32),
            "start_positions": rs.randint(6, 15, B).astype(np.int32),
            "end_positions": rs.randint(6, 15, B).astype(np.int32)}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_qa_train_step_matches_jax(impl):
    jc, tc = _cfgs(attn_impl=impl, norm_position="post")
    jp, tp = _models(jc, tc, seed=13)
    jqa = J.init_qa_head(jax.random.key(14), jc)
    tqa = qa_params_from_jax(jax.tree.map(np.asarray, jqa), tc, device="cpu")
    batch = _qa_batch()
    upd_j, upd_t = JU.Adam(1e-3), TU.Adam(1e-3)
    ref_loss = J.qa_loss_fn(jp, jqa, _jax_batch(batch), jc, None, True)
    with torch.enable_grad():
        loss0 = T.qa_loss_fn(tp, tqa, batch, tc)
    np.testing.assert_allclose(loss0.item(), float(ref_loss), rtol=LOSS_RTOL)
    # From a nonzero state: the span head's bias (and the key bias) get a
    # gradient that is zero but for rounding (a softmax ignores a shift), and
    # Adam's first step from zero would turn that noise into +-lr.
    state, qstate = _jax_state(jp, 22), _jax_state(jqa, 23)
    t_state = updater_state_from_jax(jax.tree.map(np.asarray, state), tp)
    t_qstate = updater_state_from_jax(jax.tree.map(np.asarray, qstate), tqa)
    new_jp, new_jqa, _, _, jl = J.make_qa_train_step(jc, upd_j)(
        jp, jqa, state, qstate, _jax_batch(batch), 2, None)
    _, _, opt, qopt, tl = T.make_qa_train_step(tc, upd_t)(
        tp, tqa, t_state, t_qstate, batch, 2)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    _assert_tree_close(dict(tqa.named_parameters()), _flat(new_jqa), 1e-7, 1e-6)
    _assert_tree_close(dict(tp.named_parameters()), _flat(new_jp), 1e-7, 1e-6)
    assert set(qopt["m"]) == {"w", "b"} and set(opt["m"]) == set(dict(tp.named_parameters()))


def _masks(cfg_kw, B, L, seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(B, L, cfg_kw["d_model"]) > cfg_kw["dropout"]
            for _ in range(2 * cfg_kw["n_layers"])]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dropout_with_injected_masks_matches_jax(impl, monkeypatch):
    """The same numpy masks go into both packages' dropout (in call order:
    per layer the attention output, then the FFN output); loss and grads
    then match JAX's with dropout 0.1."""
    jc, tc = _cfgs(attn_impl=impl, dropout=0.1)
    jp, tp = _models(jc, tc, seed=15)
    batch = _batch(seed=16)
    masks = _masks({**_SMALL, "dropout": 0.1}, 2, 19, 17)
    jmasks, tmasks = iter(masks), iter(masks)

    def jax_bernoulli(key, p, shape):
        m = next(jmasks)
        assert m.shape == tuple(shape) and p == pytest.approx(0.9)
        return jnp.asarray(m)

    def torch_mask(generator, keep, shape, device):
        m = next(tmasks)
        assert m.shape == tuple(shape) and keep == pytest.approx(0.9)
        return torch.from_numpy(m)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(T, "dropout_mask", torch_mask)
    ref_loss, ref_grads = jax.value_and_grad(J.loss_fn)(jp, _jax_batch(batch), jc,
                                                        jax.random.key(0), True)
    loss, grads = T.loss_and_grads(tp, batch, tc, torch.Generator())
    assert next(jmasks, None) is None and next(tmasks, None) is None
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    _assert_tree_close(grads, _flat(ref_grads), GRAD_ATOL, GRAD_RTOL)
    no_drop = T.loss_and_grads(tp, batch, dataclasses.replace(tc, dropout=0.0))[0]
    assert abs(loss.item() - no_drop.item()) > 1e-4


def test_dropout_statistics_and_the_no_op_rule():
    _, tc = _cfgs(dropout=0.25)
    x = torch.ones((64, 512))
    y = T._dropout(x, tc, torch.Generator().manual_seed(0), True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.75, rtol=1e-6)
    same = T._dropout(x, tc, torch.Generator().manual_seed(0), True)
    other = T._dropout(x, tc, torch.Generator().manual_seed(1), True)
    assert torch.equal(y, same) and not torch.equal(y, other)
    for args in ((tc, torch.Generator(), False), (tc, None, True),
                 (dataclasses.replace(tc, dropout=0.0), torch.Generator(), True)):
        assert T._dropout(x, *args) is x


def test_seeded_dropout_loss_repeats_and_serving_stays_inference():
    jc, tc = _cfgs(dropout=0.1)
    _, tp = _models(jc, tc, seed=18)
    batch = _batch(seed=19)
    a = T.loss_fn(tp, batch, tc, torch.Generator().manual_seed(5))
    b = T.loss_fn(tp, batch, tc, torch.Generator().manual_seed(5))
    c = T.loss_fn(tp, batch, tc, torch.Generator().manual_seed(6))
    d = T.loss_fn(tp, batch, tc, None)
    assert a.item() == b.item() and a.item() != c.item() and a.item() != d.item()
    assert a.requires_grad
    # train=False is the identity whatever the generator; serving records no graph
    logits = T.forward(tp, batch["tokens"], tc, generator=torch.Generator(), train=False)
    assert not logits.requires_grad and logits.is_inference()
    np.testing.assert_array_equal(logits.numpy(), T.forward(tp, batch["tokens"], tc).numpy())
    h = T.encode(tp, batch["tokens"], tc, generator=torch.Generator().manual_seed(5),
                 train=True)
    assert not torch.equal(h, T.encode(tp, batch["tokens"], tc))


def test_params_to_numpy_after_a_step_round_trips():
    jc, tc = _cfgs()
    jp, tp = _models(jc, tc, seed=20)
    upd = TU.Sgd(0.1)
    T.make_train_step(tc, upd)(tp, upd.init(tp), _batch(seed=21), 0)
    again = params_from_jax(params_to_numpy(tp), tc, device="cpu")
    for (n, a), (_, b) in zip(tp.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
