"""Port parity: the block-paged KV cache (``PagedDecodeSlotPool``), its
copy-on-write prefix sharing and speculative decoding, against the JAX
package's ``models/paged_decode.py`` on the same weights (the config of
tests/test_paged_decode.py, bridged with ``params_from_jax``).

Token ids, block tables, ``block_stats()`` and the speculative counters
must be identical; hidden states and gathered K/V: float32, atol 1e-5. The
port's decode step has one fixed signature, as the JAX one: on the CPU it
is built once and run eagerly (``decode_traces == 1`` under churn); on
CUDA it is captured once as a graph and replayed (the ``cuda``-marked test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import paged_decode as JP
from deeplearning4j_tpu.models import transformer as J
from deeplearning4j_tpu_torch.models import paged_decode as P
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models.weights import params_from_jax
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ATOL = 1e-5

_SMALL = dict(causal=True, dropout=0.0, vocab_size=97, max_len=64, d_model=32,
              n_heads=4, n_layers=2, d_ff=64)


def _cfgs(port_impl="xla", **kw):
    jc = J.TransformerConfig(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                             attn_impl="xla", **{**_SMALL, **kw})
    tc = T.TransformerConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                             attn_impl=port_impl, **{**_SMALL, **kw})
    return jc, tc


def _bridge(jp, tc, device="cpu"):
    return params_from_jax(jax.tree.map(np.asarray, jp), tc, device=device)


def _setup(seed=0, port_impl="xla", **kw):
    jc, tc = _cfgs(port_impl, **kw)
    jp = J.init_params(jax.random.key(seed), jc)
    return jc, tc, jp, _bridge(jp, tc)


def _pools(jp, jc, tp, tc, **kw):
    return JP.PagedDecodeSlotPool(jp, jc, **kw), P.PagedDecodeSlotPool(tp, tc, device="cpu", **kw)


def _jax_dense(jp, jc, prompts, max_new, **kw):
    return J.generate(jp, prompts, max_new, jc,
                      pool=J.DecodeSlotPool(jp, jc, slots=max(2, len(prompts))), **kw)


@pytest.mark.parametrize("port_impl", ["xla", "flash"])
def test_paged_decode_matches_jax_paged_and_dense_under_churn(port_impl):
    """Six ragged prompts through three slots (admission and retirement
    churn): port paged == JAX paged == JAX dense, one step signature, and
    every block free at the end."""
    jc, tc, jp, tp = _setup(port_impl=port_impl)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, 97, n).tolist() for n in (3, 9, 17, 5, 12, 2)]
    jpool, tpool = _pools(jp, jc, tp, tc, slots=3, block_T=8)
    expected = J.generate(jp, prompts, 8, jc, pool=jpool)
    assert expected == _jax_dense(jp, jc, prompts, 8)
    assert T.generate(tp, prompts, 8, tc, pool=tpool) == expected
    assert tpool.decode_traces == 1 == jpool.decode_traces
    assert tpool.prefill_traces == jpool.prefill_traces
    assert tpool.free_slots == tpool.slots
    assert tpool.block_stats() == jpool.block_stats()
    assert tpool.block_stats()["blocks_free"] == tpool.total_blocks


def test_generate_builds_the_paged_pool_by_default(monkeypatch):
    """``generate`` without a pool builds a PagedDecodeSlotPool, as JAX's
    does (both default pools give JAX dense's tokens); a passed dense pool
    still works."""
    jc, tc, jp, tp = _setup(seed=1)
    built = {}
    real = T.PagedDecodeSlotPool

    class Spy(real):
        def __init__(self, *a, **kw):
            built["kw"] = kw
            super().__init__(*a, **kw)

    monkeypatch.setattr(T, "PagedDecodeSlotPool", Spy)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, 97, n).tolist() for n in (3, 9, 17, 5, 30)]
    got = T.generate(tp, prompts, 8, tc, slots=2, device="cpu")
    assert built, "default generate() did not build a PagedDecodeSlotPool"
    assert built["kw"]["block_T"] == 16 and built["kw"]["slots"] == 2
    assert got == J.generate(jp, prompts, 8, jc, slots=2) == _jax_dense(jp, jc, prompts, 8)
    pool = T.DecodeSlotPool(tp, tc, slots=2, device="cpu")
    assert T.generate(tp, prompts, 8, tc, pool=pool) == got
    assert T.PagedDecodeSlotPool is Spy and P.PagedDecodeSlotPool is real


def test_block_accounting_and_admission_priced_in_blocks():
    """JAX's exact numbers, and ``block_stats()`` equal to the JAX pool's
    after every call."""
    jc, tc, jp, tp = _setup(max_len=32)
    jpool, tpool = _pools(jp, jc, tp, tc, slots=8, block_T=8, n_blocks=10)
    for pool, mod in ((jpool, JP), (tpool, P)):
        assert pool.total_blocks == 9
        assert pool.request_blocks(5, 4) == 2  # span 9 -> 2 blocks
        with pytest.raises(ValueError, match="exceeds"):
            pool.admit(list(range(1, 30)), max_new_tokens=8)
        s0, _ = pool.admit([1, 2, 3, 4, 5], max_new_tokens=18)  # span 23 -> 3
        s1, _ = pool.admit([6, 7, 8, 9, 10], max_new_tokens=18)
        assert pool.block_stats()["blocks_free"] == 3
        assert not pool.can_admit([11, 12], max_new_tokens=28)
        with pytest.raises(mod.NoFreeBlocksError) as ei:
            pool.admit([11, 12], max_new_tokens=28)
        assert ei.value.retry_admission
        assert pool.free_slots == 6
        pool.release(s0)
        assert pool.can_admit([11, 12], max_new_tokens=28)
        pool.release(s1)
        assert pool.block_stats()["blocks_free"] == 9
    assert tpool.block_stats() == jpool.block_stats()
    assert T.NoFreeBlocksError is P.NoFreeBlocksError and T.BlockAllocator is P.BlockAllocator
    # 4 requests of 3 blocks each, 9 blocks: the fourth finds a free slot
    # but no blocks, so generate drains live sequences and admits it later
    prompts = [[i + 1, i + 2] for i in range(4)]
    want = J.generate(jp, prompts, 20, jc, pool=jpool)
    assert T.generate(tp, prompts, 20, tc, pool=tpool) == want
    assert want == _jax_dense(jp, jc, prompts, 20)
    assert tpool.block_stats() == jpool.block_stats()
    assert tpool.block_stats()["blocks_free"] == 9


def test_cow_prefix_sharing_matches_jax_and_solo_runs():
    """Two prompts sharing two full 8-token blocks: the sharer maps the same
    physical blocks and pays fewer, the stats equal JAX's at each point, and
    each prompt's tokens equal what it generates alone."""
    jc, tc, jp, tp = _setup()
    rs = np.random.RandomState(3)
    prefix = rs.randint(1, 97, 16).tolist()
    a, b = prefix + [11, 12], prefix + [13, 14, 15]
    solo = _jax_dense(jp, jc, [a, b], 6)
    jpool, tpool = _pools(jp, jc, tp, tc, slots=4, block_T=8)
    runs = []
    for pool in (jpool, tpool):
        free0 = pool.block_stats()["blocks_free"]
        sa, fa = pool.admit(a, max_new_tokens=6)
        used_a = free0 - pool.block_stats()["blocks_free"]
        sb, fb = pool.admit(b, max_new_tokens=6)
        used_b = (free0 - used_a) - pool.block_stats()["blocks_free"]
        shared = pool.block_stats()
        assert shared["cow_shared_blocks"] == 2 and shared["cow_saved_blocks"] >= 2
        assert used_b < used_a
        toks = {sa: [fa], sb: [fb]}
        while len(toks[sa]) < 6 or len(toks[sb]) < 6:
            for slot, new in pool.step().items():
                toks[slot].extend(new)
        tables = pool._tables.copy()
        pool.release(sa), pool.release(sb)
        assert pool.block_stats()["blocks_free"] == free0
        assert pool.block_stats()["cow_shared_blocks"] == 0
        runs.append((shared, [toks[sa], toks[sb]], tables))
    assert runs[1][0] == runs[0][0]
    assert runs[1][1] == runs[0][1] == solo
    np.testing.assert_array_equal(runs[1][2], runs[0][2])


def test_cow_copies_a_joined_tail_block_before_its_first_write():
    """The same 13-token prompt twice (block_T 8): the second admission
    joins the first's partial tail block, holds a reserve, and copies the
    block at its first step; tables, stats and tokens equal JAX's."""
    jc, tc, jp, tp = _setup(seed=6)
    prompt = np.random.RandomState(6).randint(1, 97, 13).tolist()
    (solo,) = _jax_dense(jp, jc, [prompt], 5)
    jpool, tpool = _pools(jp, jc, tp, tc, slots=3, block_T=8)
    seen = []
    for pool in (jpool, tpool):
        s0, f0 = pool.admit(prompt, max_new_tokens=5)
        s1, f1 = pool.admit(prompt, max_new_tokens=5)
        joined = (pool.block_stats(), pool._alloc.reserved, pool._tables.copy())
        toks = {s0: [f0], s1: [f1]}
        for _ in range(4):
            for slot, new in pool.step().items():
                toks[slot].extend(new)
        after_cow = (pool.block_stats(), pool._alloc.reserved, pool._tables.copy())
        pool.release(s0), pool.release(s1)
        seen.append((joined, after_cow, [toks[s0], toks[s1]], pool.block_stats()))
    (j_join, j_cow, j_toks, j_end), (t_join, t_cow, t_toks, t_end) = seen
    assert t_join[0] == j_join[0] and t_join[0]["cow_shared_blocks"] == 2
    assert t_join[1] == j_join[1] == 1  # the CoW reserve
    assert t_cow[0] == j_cow[0] and t_cow[1] == j_cow[1] == 0
    for a, b in ((t_join[2], j_join[2]), (t_cow[2], j_cow[2])):
        np.testing.assert_array_equal(a, b)
    assert t_toks == j_toks == [solo, solo]
    assert t_end == j_end and t_end["blocks_free"] == tpool.total_blocks


def _identity_tail_draft(params, cfg, draft_layers):
    """(target, draft, draft_cfg) JAX trees: the target's blocks from
    ``draft_layers`` on get zero ``out_w`` and ``ffn_w2``, and the draft is
    its first ``draft_layers`` blocks. The zeroed blocks are exact no-ops
    only because the config is pre-LN (``norm_position="pre"``, the default)
    and ``init_params`` leaves every bias at zero: each such block then adds
    zero to the residual stream, so the draft's argmax is the target's."""
    blocks = [dict(b) for b in params["blocks"]]
    for blk in blocks[draft_layers:]:
        blk["out_w"] = jnp.zeros_like(blk["out_w"])
        blk["ffn_w2"] = jnp.zeros_like(blk["ffn_w2"])
    target = {"embed": params["embed"], "mlm": params["mlm"], "blocks": blocks}
    draft = {"embed": params["embed"], "mlm": params["mlm"], "blocks": blocks[:draft_layers]}
    return target, draft, dataclasses.replace(cfg, n_layers=draft_layers)


def _spec_models(draft_kind):
    """(jc, tc, target JAX tree, port target, JAX draft tree, port draft,
    JAX draft cfg, port draft cfg)."""
    jc, tc, jp, _ = _setup()
    if draft_kind == "identity_tail":
        jp, jdp, jdc = _identity_tail_draft(jp, jc, 1)
    else:
        jdc = dataclasses.replace(jc, n_layers=1)
        jdp = J.init_params(jax.random.key(9), jdc)  # unrelated weights
    tdc = dataclasses.replace(tc, n_layers=1)
    return jc, tc, jp, _bridge(jp, tc), jdp, _bridge(jdp, tdc), jdc, tdc


@pytest.mark.parametrize("draft_kind", ["random", "identity_tail"])
def test_speculative_decode_matches_jax(draft_kind):
    """Speculation changes no token: with a draft that always agrees and
    with one that rarely does, the port's tokens equal plain greedy decode
    and the JAX speculative pool's; ``spec_proposed``/``spec_accepted``
    equal the JAX pool's exactly; max_new 7 is not a multiple of
    spec_tokens + 1, so the budget clamp runs; one step signature. The
    identity-tail case also pins an EOS inside an accepted window."""
    jc, tc, jp, tp, jdp, tdp, jdc, tdc = _spec_models(draft_kind)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, 97, n).tolist() for n in (3, 10, 6)]
    eos_prompt = [5, 9, 2]
    refs = _jax_dense(jp, jc, prompts + [eos_prompt], 8)
    kw = dict(slots=3, block_T=8, spec_tokens=3)
    jpool = JP.PagedDecodeSlotPool(jp, jc, draft_params=jdp, draft_cfg=jdc, **kw)
    tpool = P.PagedDecodeSlotPool(tp, tc, draft_params=tdp, draft_cfg=tdc, device="cpu", **kw)
    want = J.generate(jp, prompts, 7, jc, pool=jpool)
    assert want == [r[:7] for r in refs[:3]]
    assert T.generate(tp, prompts, 7, tc, pool=tpool) == want
    assert tpool.decode_traces == 1 == jpool.decode_traces
    stats = tpool.block_stats()
    assert stats == jpool.block_stats() and stats["spec_proposed"] > 0
    rate = stats["spec_accepted"] / stats["spec_proposed"]
    if draft_kind == "identity_tail":
        assert rate == pytest.approx(1.0)
        eos_ref = refs[3]
        eos = eos_ref[2]
        cut = eos_ref.index(eos) + 1
        out = T.generate(tp, [eos_prompt], 8, tc, pool=tpool, eos_id=eos)
        assert out == J.generate(jp, [eos_prompt], 8, jc, pool=jpool, eos_id=eos)
        assert out == [eos_ref[:cut]]
        assert tpool.decode_traces == 1
        assert tpool.block_stats() == jpool.block_stats()
    else:
        assert rate < 0.5


def test_speculative_generate_default_pool_matches_jax():
    """``generate`` with ``draft_params``/``draft_cfg`` and no pool, in both
    packages: the same tokens as plain greedy decoding."""
    jc, tc, jp, tp, jdp, tdp, jdc, tdc = _spec_models("random")
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, 97, n).tolist() for n in (4, 20, 9, 33)]
    want = J.generate(jp, prompts, 6, jc, slots=3, draft_params=jdp, draft_cfg=jdc,
                      spec_tokens=2)
    assert want == _jax_dense(jp, jc, prompts, 6)
    assert T.generate(tp, prompts, 6, tc, slots=3, draft_params=tdp, draft_cfg=tdc,
                      spec_tokens=2, device="cpu") == want


@pytest.mark.parametrize("norm", ["pre", "post"])
def test_arena_contents_match_jax_after_admissions_and_steps(norm):
    """Two admissions and three steps: block tables equal exactly, and the
    K/V gathered through them (every written position of each live slot)
    within atol 1e-5, in every layer."""
    jc, tc, jp, tp = _setup(seed=5, norm_position=norm)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 97, n).tolist() for n in (11, 19)]
    jpool, tpool = _pools(jp, jc, tp, tc, slots=3, block_T=8)
    outs = []
    for pool in (jpool, tpool):
        firsts = [pool.admit(p, max_new_tokens=6)[1] for p in prompts]
        outs.append((firsts, [pool.step() for _ in range(3)]))
    assert outs[1] == outs[0]
    np.testing.assert_array_equal(tpool._tables, jpool._tables)
    np.testing.assert_array_equal(tpool._positions, jpool._positions)
    L, NB, bT, H, hd = tpool._kc.shape
    for slot in np.flatnonzero(tpool._active):
        n, row = int(tpool._positions[slot]), tpool._tables[slot]
        for t_arena, j_arena in ((tpool._kc, jpool._kc), (tpool._vc, jpool._vc)):
            got = t_arena.numpy()[:, row].reshape(L, -1, H, hd)[:, :n]
            ref = np.asarray(j_arena)[:, row].reshape(L, -1, H, hd)[:, :n]
            np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("norm", ["pre", "post"])
def test_paged_window_block_matches_jax(norm):
    """One block over a 3-token window on a random flat arena: the same
    hidden state, and the port's in-place arena write equals JAX's
    returned arena."""
    jc, tc, jp, tp = _setup(seed=8, norm_position=norm)
    rs = np.random.RandomState(8)
    S, W, NB, bT, max_blocks = 2, 3, 7, 8, 3
    h = rs.randn(S, W, 32).astype(np.float32)
    kf = rs.randn(NB * bT, 4, 8).astype(np.float32)
    vf = rs.randn(NB * bT, 4, 8).astype(np.float32)
    tables = np.array([[3, 1, 5], [2, 6, 0]])
    positions = np.array([[9, 10, 11], [4, 5, 6]])
    cells = np.take_along_axis(tables, positions // bT, axis=1) * bT + positions % bT
    kv_mask = np.arange(max_blocks * bT)[None, None, :] <= positions[:, :, None]
    h0, k0, v0 = JP._paged_window_block(
        jc, jp["blocks"][0], *(jnp.asarray(a) for a in (h, kf, vf, tables, cells, kv_mask)),
        NB, bT)
    tkf, tvf = torch.from_numpy(kf.copy()), torch.from_numpy(vf.copy())
    with torch.no_grad():
        out = P._paged_window_block(tc, tp.blocks[0], torch.from_numpy(h), tkf, tvf,
                                    torch.from_numpy(tables), torch.from_numpy(cells),
                                    torch.from_numpy(kv_mask), NB, bT)
    np.testing.assert_allclose(out.numpy(), np.asarray(h0), atol=ATOL)
    np.testing.assert_allclose(tkf.numpy(), np.asarray(k0), atol=ATOL)
    np.testing.assert_allclose(tvf.numpy(), np.asarray(v0), atol=ATOL)


@pytest.mark.parametrize("where", ["step", "prefill", "cow_copy"])
def test_failed_call_raises_kv_cache_lost_and_heals_the_pool(where):
    """A call that fails part-way (monkeypatched to raise) gives
    KvCacheLostError; the pool is healed (zero arenas, all slots and blocks
    free, a fresh prefix index) and the next admission works, with JAX's
    tokens."""
    jc, tc, jp, tp = _setup(seed=4)
    pool = P.PagedDecodeSlotPool(tp, tc, slots=2, block_T=8, device="cpu")
    shared = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]  # 10 tokens: a partial tail block
    pool.admit(shared, max_new_tokens=4)

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    attr = {"step": "_decode_fn", "prefill": "_prefill_fn", "cow_copy": "_copy_fn"}[where]
    real = getattr(pool, attr)
    setattr(pool, attr, boom)
    with pytest.raises(T.KvCacheLostError) as ei:
        if where == "prefill":
            pool.admit([2, 7], max_new_tokens=4)
        else:
            if where == "cow_copy":
                pool.admit(shared, max_new_tokens=4)  # joins the tail block
            pool.step()
    assert ei.value.all_sequences_lost
    assert pool.free_slots == pool.slots
    assert pool.block_stats()["blocks_free"] == pool.total_blocks
    assert pool._alloc.lookup(("full", np.asarray(shared[:8], np.int32).tobytes())) is None
    assert not pool._kc.any() and not pool._vc.any()
    setattr(pool, attr, real)
    prompt = [5, 9, 2]
    assert T.generate(tp, [prompt], 4, tc, pool=pool) == _jax_dense(jp, jc, [prompt], 4)


def test_out_of_range_prompt_ids_are_refused_before_any_gather():
    """Deliberate divergence (the dense pool makes it too): JAX
    clamps such ids into a silently wrong generation; on the card a torch
    gather would hit a device-side assert that poisons the CUDA context, so
    the port raises ValueError at admission, before any block is taken."""
    _, tc, _, tp = _setup()
    pool = P.PagedDecodeSlotPool(tp, tc, slots=2, block_T=8, device="cpu")
    for bad in ([1, 97], [-1, 5], [2 ** 40]):
        with pytest.raises(ValueError, match=r"token ids must lie in \[0, 97\)"):
            pool.admit(bad, max_new_tokens=2)
    assert pool.free_slots == 2
    assert pool.block_stats()["blocks_free"] == pool.total_blocks


def test_constructor_checks_mirror_jax():
    jc, tc, jp, tp = _setup()
    jdc, tdc = (dataclasses.replace(c, n_layers=1) for c in (jc, tc))
    cases = [
        (dict(cfg_kw={"causal": False}), "causal"),
        (dict(slots=0), "slots must be >= 1"),
        (dict(block_T=12), "power of two"),
        (dict(max_len=128), "exceeds the model's positional range"),
        (dict(max_len=40, block_T=16), "multiple of block_T"),
        (dict(draft=True, cfg_only=True), "BOTH draft_params"),
        (dict(draft=True, spec_tokens=0), "spec_tokens must be >= 1"),
        (dict(draft=True, dcfg_kw={"causal": False}), "draft model must be causal"),
        (dict(draft=True, dcfg_kw={"vocab_size": 98}), "draft vocab"),
        (dict(draft=True, dcfg_kw={"max_len": 32}), "draft positional range"),
    ]
    for mod, params, cfg, dcfg, extra in ((JP, jp, jc, jdc, {}), (P, tp, tc, tdc, {"device": "cpu"})):
        for spec, match in cases:
            spec = dict(spec)
            c = dataclasses.replace(cfg, **spec.pop("cfg_kw", {}))
            kw = dict(extra)
            if spec.pop("draft", False):
                kw["draft_cfg"] = dataclasses.replace(dcfg, **spec.pop("dcfg_kw", {}))
                if not spec.pop("cfg_only", False):
                    kw["draft_params"] = params  # never reached: the check comes first
            with pytest.raises(ValueError, match=match):
                mod.PagedDecodeSlotPool(params, c, **spec, **kw)


def test_params_from_jax_takes_a_draft_tree_with_fewer_blocks():
    """A draft config with fewer layers than the target bridges from a tree
    whose ``blocks`` list is the target's first blocks, and runs the same
    forward as JAX."""
    jc, tc, jp, _ = _setup(seed=2)
    _, jdp, jdc = _identity_tail_draft(jp, jc, 1)
    tdc = dataclasses.replace(tc, n_layers=1)
    tdp = _bridge(jdp, tdc)
    assert len(tdp.blocks) == 1
    toks = np.random.RandomState(2).randint(1, 97, (2, 9))
    np.testing.assert_allclose(T.forward(tdp, toks, tdc).numpy(),
                               np.asarray(J.forward(jdp, jnp.asarray(toks), jdc)), atol=ATOL)
    with pytest.raises(KeyError, match="parameter names differ"):
        _bridge(jdp, tc)  # the 2-layer target config wants blocks.1.*


@pytest.mark.cuda
def test_graph_replayed_step_matches_the_eager_step_on_the_card():
    """On the card the step runs only as a replay of its graph. A replay
    gives the outputs and the arena of the same step run eagerly from the
    same arena and inputs, for a plain and a speculative pool; parameters
    on the CPU are refused for a CUDA pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # d_model 64: head dim 16, a width the flash kernel takes for the prefills
    jc, tc, jp, tp_cpu = _setup(seed=3, port_impl="flash", d_model=64)
    with pytest.raises(ValueError, match="params live on cpu"):
        T.generate(tp_cpu, [[1, 2, 3]], 2, tc, device="cuda")
    tp = tp_cpu.to("cuda")
    tdc = dataclasses.replace(tc, n_layers=1)
    tdp = T.init_params(9, tdc, device="cpu")
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 97, n).tolist() for n in (5, 17, 30)]
    for draft in (None, tdp.to("cuda")):
        kw = dict(draft_params=draft, draft_cfg=tdc, spec_tokens=3) if draft is not None else {}
        pool = P.PagedDecodeSlotPool(tp, tc, slots=3, block_T=8, device="cuda", **kw)
        for p in prompts:
            pool.admit(p, max_new_tokens=12)
        pool.step()  # captures the step, then replays it
        assert (pool.decode_traces, pool.graph_replays) == (1, 1)
        before = [a.clone() for a in pool._arenas()]
        host = [a.copy() for a in (pool._tables, pool._tokens, pool._positions)]
        replayed = pool._decode_fn(*host)
        after = [a.clone() for a in pool._arenas()]
        assert (pool.decode_traces, pool.graph_replays) == (1, 2)
        for arena, saved in zip(pool._arenas(), before):
            arena.copy_(saved)
        with torch.inference_mode():
            eager = [t.cpu().numpy()
                     for t in pool._step_body(*(torch.from_numpy(a).cuda() for a in host))]
        for r, e in zip(replayed, eager):
            np.testing.assert_array_equal(r, e)
        for arena, replayed_arena in zip(pool._arenas(), after):
            torch.testing.assert_close(arena, replayed_arena, atol=ATOL, rtol=0)
