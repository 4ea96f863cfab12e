"""Port parity: greedy generation of ``deeplearning4j_tpu_torch`` against
the JAX package — ``prefill_forward``, the dense ``DecodeSlotPool`` and
``generate`` on the same weights (the config of tests/test_generate.py).

Token ids must be identical. Without a pool, the ``generate`` of both
packages builds the paged pool (tests/test_torch_paged_decode.py holds the
two paged pools against each other); the dense-pool tests here pass
``pool=DecodeSlotPool(...)``, and the port is held against both JAX pools.
Hidden states and K/V: float32, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import params_from_jax
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ATOL = 1e-5

_SMALL = dict(causal=True, dropout=0.0, vocab_size=97, max_len=64, d_model=32,
              n_heads=4, n_layers=2, d_ff=64)


def _setup(seed=0, port_impl="xla", **kw):
    jc = J.TransformerConfig(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                             attn_impl="xla", **{**_SMALL, **kw})
    tc = T.TransformerConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                             attn_impl=port_impl, **{**_SMALL, **kw})
    jp = J.init_params(jax.random.key(seed), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


@pytest.mark.parametrize("port_impl", ["xla", "flash"])
def test_prefill_forward_matches_jax(port_impl):
    jc, tc, jp, tp = _setup(port_impl=port_impl)
    toks = np.random.RandomState(0).randint(1, 97, (2, 11)).astype(np.int32)
    h0, k0, v0 = J.prefill_forward(jp, jnp.asarray(toks), jc)
    h, k, v = T.prefill_forward(tp, toks, tc)
    assert tuple(k.shape) == (2, 2, 4, 11, 8) and k.shape == v.shape
    for a, b in ((h, h0), (k, k0), (v, v0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), T.encode(tp, toks, tc).numpy(), atol=ATOL)


@pytest.mark.parametrize("port_impl", ["xla", "flash"])
@pytest.mark.parametrize("slots", [1, 2, 3])
def test_generate_matches_jax_dense_and_paged(port_impl, slots):
    """Ragged prompts, more prompts than slots (continuous admission)."""
    jc, tc, jp, tp = _setup(seed=1, port_impl=port_impl)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, 97, n).tolist() for n in (3, 9, 17, 5, 30)]
    dense = J.generate(jp, prompts, 8, jc, pool=J.DecodeSlotPool(jp, jc, slots=slots))
    paged = J.generate(jp, prompts, 8, jc, slots=slots)
    got = T.generate(tp, prompts, 8, tc, slots=slots, device="cpu")
    assert got == dense == paged
    pool = T.DecodeSlotPool(tp, tc, slots=slots, device="cpu")
    assert T.generate(tp, prompts, 8, tc, pool=pool) == dense
    assert pool.free_slots == slots


def test_generate_eos_matches_jax():
    jc, tc, jp, tp = _setup(seed=2, port_impl="flash")
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, 97, n).tolist() for n in (4, 12, 7)]
    full = J.generate(jp, prompts, 8, jc, pool=J.DecodeSlotPool(jp, jc, slots=2))
    eos = full[1][2]  # stops prompt 1 at its third token (and any other that emits it)
    ref = J.generate(jp, prompts, 8, jc, eos_id=eos, pool=J.DecodeSlotPool(jp, jc, slots=2))
    got = T.generate(tp, prompts, 8, tc, eos_id=eos, slots=2, device="cpu")
    assert got == ref
    assert got[1] == full[1][:3]
    pool = T.DecodeSlotPool(tp, tc, slots=2, eos_id=eos, device="cpu")
    assert T.generate(tp, prompts, 8, tc, pool=pool) == ref


def _churn(mod, params, cfg, prompts, **pool_kw):
    """Admit and retire around a live sequence, in both packages alike."""
    long_p, short_a, short_b = prompts
    pool = mod.DecodeSlotPool(params, cfg, slots=2, **pool_kw)
    slot_l, first_l = pool.admit(long_p, max_new_tokens=10)
    toks_l = [first_l]
    for _ in range(3):
        toks_l.append(pool.step()[slot_l])
    slot_a, first_a = pool.admit(short_a, max_new_tokens=3)
    toks_a = [first_a]
    while len(toks_a) < 3:
        out = pool.step()
        toks_l.append(out[slot_l])
        toks_a.append(out[slot_a])
    pool.release(slot_a)
    slot_b, first_b = pool.admit(short_b, max_new_tokens=2)
    toks_b = [first_b]
    while len(toks_l) < 10:
        out = pool.step()
        toks_l.append(out[slot_l])
        if slot_b in out and len(toks_b) < 2:
            toks_b.append(out[slot_b])
            if len(toks_b) == 2:
                pool.release(slot_b)
    pool.release(slot_l)
    return toks_l, toks_a, toks_b, (slot_l, slot_a, slot_b)


@pytest.mark.parametrize("norm", ["pre", "post"])
def test_membership_churn_matches_jax(norm):
    jc, tc, jp, tp = _setup(seed=3, port_impl="flash", norm_position=norm)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, 97, n).tolist() for n in (4, 6, 2)]
    assert _churn(T, tp, tc, prompts, device="cpu") == _churn(J, jp, jc, prompts)


def test_pool_validation_errors_mirror_jax():
    jc, tc, jp, tp = _setup()
    for mod, params, cfg, kw in ((J, jp, jc, {}), (T, tp, tc, {"device": "cpu"})):
        bidir = type(cfg)(**{**cfg.__dict__, "causal": False})
        with pytest.raises(ValueError, match="causal"):
            mod.DecodeSlotPool(params, bidir, slots=2, **kw)
        with pytest.raises(ValueError, match="slots must be >= 1"):
            mod.DecodeSlotPool(params, cfg, slots=0, **kw)
        with pytest.raises(ValueError, match="exceeds"):
            mod.DecodeSlotPool(params, cfg, slots=1, max_len=128, **kw)
        pool = mod.DecodeSlotPool(params, cfg, slots=1, max_len=16, **kw)
        with pytest.raises(ValueError, match="exceeds"):
            pool.admit(list(range(1, 15)), max_new_tokens=8)
        with pytest.raises(ValueError, match="at least one token"):
            pool.admit([], max_new_tokens=1)
        with pytest.raises(ValueError, match="max_new_tokens"):
            pool.admit([1], max_new_tokens=0)
        slot, _ = pool.admit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="no free decode slot"):
            pool.admit([4], max_new_tokens=1)
        pool.release(slot)
        with pytest.raises(ValueError, match="not active"):
            pool.release(slot)
        assert pool.step() == {}
        pool.admit([4], max_new_tokens=1)
        assert (pool.free_slots, pool.occupancy, pool.vocab_size) == (0, 1, 97)
        assert mod.generate(params, [], 4, cfg) == []
        with pytest.raises(ValueError, match="max_new_tokens"):
            mod.generate(params, [[1, 2]], 0, cfg)


def test_prompt_buckets_mirror_jax():
    jc, tc, jp, tp = _setup()
    jpool = J.DecodeSlotPool(jp, jc, slots=2, min_prompt_bucket=8)
    tpool = T.DecodeSlotPool(tp, tc, slots=2, min_prompt_bucket=8, device="cpu")
    for n in range(1, 64):
        assert tpool.prompt_bucket(n) == jpool.prompt_bucket(n)
    assert tpool.prompt_bucket(63) == tc.max_len


def test_out_of_range_prompt_ids_are_refused_before_any_gather():
    """JAX clamps such ids into a silently wrong generation; on the card a
    torch gather would raise a device-side assert that poisons the CUDA
    context, so the port refuses them at admission."""
    _, tc, _, tp = _setup()
    pool = T.DecodeSlotPool(tp, tc, slots=2, device="cpu")
    for bad in ([1, 97], [-1, 5]):
        with pytest.raises(ValueError, match=r"token ids must lie in \[0, 97\)"):
            pool.admit(bad, max_new_tokens=2)
    assert pool.free_slots == 2


def test_failed_call_resets_the_pool_not_poisons_it():
    """The cache is updated in place, so a call that fails part-way may
    leave it half-written: the pool resets (zero cache, all slots free,
    KvCacheLostError with the all_sequences_lost marker) and keeps
    serving, as the JAX pool does after a failed donated call."""
    jc, tc, jp, tp = _setup(seed=4)
    pool = T.DecodeSlotPool(tp, tc, slots=2, device="cpu")
    pool.admit([3, 1, 4], max_new_tokens=4)

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    real_decode, real_prefill = pool._decode_fn, pool._prefill_fn
    pool._decode_fn = boom
    with pytest.raises(T.KvCacheLostError) as ei:
        pool.step()
    assert ei.value.all_sequences_lost
    assert pool.free_slots == pool.slots and not pool._kc.any()
    pool._decode_fn = real_decode
    pool._prefill_fn = boom
    with pytest.raises(T.KvCacheLostError):
        pool.admit([5, 9], max_new_tokens=2)
    pool._prefill_fn = real_prefill
    prompt = [5, 9, 2]
    ref = J.generate(jp, [prompt], 4, jc, pool=J.DecodeSlotPool(jp, jc, slots=2))
    assert T.generate(tp, [prompt], 4, tc, pool=pool) == ref


def test_kv_cache_layout_and_decode_block_match_jax():
    """One decode step of one layer on a filled cache: same hidden state,
    and the port's in-place cache write equals JAX's returned cache."""
    jc, tc, jp, tp = _setup(seed=5)
    rs = np.random.RandomState(5)
    S, maxT = 3, 16
    h = rs.randn(S, 32).astype(np.float32)
    kc = rs.randn(S, maxT, 4, 8).astype(np.float32)
    vc = rs.randn(S, maxT, 4, 8).astype(np.float32)
    positions = np.array([0, 7, 15])
    kv_mask = np.arange(maxT)[None, :] <= positions[:, None]
    h0, k0, v0 = J._decode_block(jc, jp["blocks"][1], *(jnp.asarray(a) for a in
                                 (h, kc, vc, positions, kv_mask)))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    with torch.no_grad():  # the pool runs it so; the parameters are trainable
        out = T._decode_block(tc, tp.blocks[1], torch.from_numpy(h), tkc, tvc,
                              torch.from_numpy(positions), torch.from_numpy(kv_mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(h0), atol=ATOL)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(k0), atol=ATOL)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(v0), atol=ATOL)
    cache = T.init_kv_cache(tc, 3, 16, device="cpu")
    ref = J.init_kv_cache(jc, 3, 16)
    assert tuple(cache["k"].shape) == ref["k"].shape and not cache["v"].any()
