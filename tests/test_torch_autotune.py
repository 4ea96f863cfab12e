"""The port's flash tile table (``deeplearning4j_tpu_torch.kernels.
autotune``), mirroring ``tests/test_autotune.py``.

Pinned here:
- the static table is the H100's (bf16: 64-row q-tiles; float32: the
  kernel's own block-count rule; block_k 64), not the TPU's;
- shape keys keep the JAX format, but sequence lengths bucket from 16 where
  JAX's bucket from 128: the port's 32- and 64-token prefill buckets get
  entries of their own, where JAX's 128-token pad shim merged them;
- off the card the search records the static choice unmeasured
  (``measured: false``), as JAX does in interpret mode;
- the regression guard keeps the static choice against a slower "winner";
  a candidate whose launch raises is not skipped (JAX skips it): the error
  propagates;
- the table round-trips, tolerates corruption, and ignores a table written
  on another card;
- ``flash_attention`` consults the table (the lookup counter moves, the
  resolved tile reaches the kernel's Function, the result is unchanged) and
  refuses a block_k other than 64 and a q-tile the kernel does not have.

Tolerance: the CPU results are compared with ``mha_reference`` to 2e-5
(float32 sums in another order); the ``cuda``-marked tests hold each tile
height to its plain version with the bounds of ``chip_smoke.py`` phase 2.
"""

import json
import logging

import jax.numpy as jnp  # noqa: F401  (the JAX package's tests import jax first)
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import autotune as JA
from deeplearning4j_tpu_torch.kernels import attention as A
from deeplearning4j_tpu_torch.kernels import autotune as AT
from deeplearning4j_tpu_torch.kernels.autotune import (AutotuneTable, autotune_flash_attention,
                                                       resolve_blocks, shape_key,
                                                       static_flash_blocks)
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

ATOL = 2e-5


def _lookups(source):
    return AT.METRICS["tdl_autotune_lookups_total"][("flash_attention", source)]


@pytest.fixture
def tmp_table_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(AT.ENV_DIR, str(tmp_path))
    AT.reset_table()
    yield tmp_path
    AT.reset_table()


# ------------------------------------------------------------ static table


def test_static_table_is_the_h100_s():
    for T in (16, 32, 128, 512, 8192):
        assert static_flash_blocks(T, T, "bfloat16") == (64, 64)
    # float32: 32-row q-tiles where they still give each of the 132 SMs two
    # blocks, else 16 (PERF.md: a causal 512-token prefill of 12 heads runs
    # 384 blocks of 16 rows, the B=16 training shape 768 blocks of 32)
    assert static_flash_blocks(512, 512, "float32", batch_heads=12) == (16, 64)
    assert static_flash_blocks(128, 128, "float32", batch_heads=16 * 12) == (32, 64)
    assert static_flash_blocks(128, 128, "float32", batch_heads=12) == (16, 64)
    assert static_flash_blocks(128, 128, "float32", batch_heads=12, sms=24) == (32, 64)
    for bh in (1, 12, 66, 67, 192):
        for T in (1, 31, 32, 33, 511, 512, 4096):
            rows = 32 if -(-T // 32) * bh >= 2 * 132 else 16
            assert AT.f32_q_rows(bh, T, 132) == rows
    assert JA.static_flash_blocks(128, 128) == (128, 128)  # the TPU's, not carried over


def test_shape_key_buckets_from_16_where_jax_buckets_from_128():
    key = shape_key("flash_attention", B=1, H=12, Tq=300, Tk=300, D=64, dtype="float32")
    assert key == "flash_attention|bh16|tq512|tk512|d64|float32"
    for T in (128, 512, 8192):  # at and past 128 the keys are JAX's
        kw = dict(B=2, H=12, Tq=T, Tk=T, D=64, dtype="bfloat16")
        assert shape_key("flash_attention", **kw) == JA.shape_key("flash_attention", **kw)
    k20, k32, k64 = (shape_key("flash_attention", B=1, H=12, Tq=T, Tk=T, D=64,
                               dtype="float32") for T in (20, 32, 64))
    assert k20 == k32 and "tq32|tk32" in k32 and "tq64|tk64" in k64 and k32 != k64
    assert JA.shape_key("flash_attention", B=1, H=12, Tq=32, Tk=32, D=64, dtype="float32") == \
        JA.shape_key("flash_attention", B=1, H=12, Tq=64, Tk=64, D=64, dtype="float32")
    assert shape_key("flash_attention", B=1, H=12, Tq=32, Tk=32, D=64, dtype="bfloat16") != k32


def test_candidate_validity_filters():
    assert AT.candidate_valid(32, 64, 32, 32, 64, "bfloat16")
    assert not AT.candidate_valid(64, 64, 32, 32, 64, "bfloat16")      # taller than Tq's bucket
    assert AT.candidate_valid(64, 64, 33, 33, 64, "bfloat16")          # 33 buckets to 64
    assert AT.candidate_valid(128, 64, 512, 512, 128, "bfloat16")
    assert not AT.candidate_valid(128, 128, 512, 512, 64, "bfloat16")  # block_k is 64
    assert not AT.candidate_valid(16, 64, 512, 512, 64, "bfloat16")    # no 16-row bf16 tile
    assert not AT.candidate_valid(64, 64, 512, 512, 64, "float32")     # no 64-row f32 tile
    assert AT.candidate_valid(32, 64, 512, 512, 128, "float32")
    # the Hopper budget: the kernel's shared memory against the opt-in limit
    assert AT.fwd_smem_bytes(64, 64, "bfloat16") == 46592
    assert AT.fwd_smem_bytes(16, 64, "float32") == 70144
    assert AT.fwd_smem_bytes(32, 64, "float32") == 78848
    assert not AT.candidate_valid(32, 64, 512, 512, 128, "float32",
                                  smem_limit=AT.fwd_smem_bytes(32, 128, "float32") - 1)
    for dt, cands in AT.FLASH_CANDIDATES.items():
        assert [bq for bq, _ in cands] == list(AT.FWD_Q_ROWS[dt])
        assert all(AT.candidate_valid(bq, bk, 512, 512, 128, dt) for bq, bk in cands)


# ---------------------------------------------------- deterministic search


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_search_records_the_static_choice_unmeasured(dtype, tmp_path):
    table = AutotuneTable(str(tmp_path / "autotune_cuda.json"))
    dt = AT.dtype_name(dtype)
    for B, T in ((1, 32), (1, 64), (1, 512), (16, 128)):
        e1 = autotune_flash_attention(B, 12, T, 64, dtype, table=table, device="cpu")
        e2 = autotune_flash_attention(B, 12, T, 64, dtype, table=table, device="cpu")
        assert e1 == e2 == {"block_q": static_flash_blocks(T, T, dt, batch_heads=B * 12)[0],
                            "block_k": 64, "measured": False, "source": "static-fallback",
                            "trials": 0}
        before = _lookups("table")
        assert resolve_blocks("flash_attention", B=B, H=12, Tq=T, Tk=T, D=64, dtype=dt,
                              table=table) == (e1["block_q"], 64)
        assert _lookups("table") == before + 1
    assert len(AutotuneTable(table.path)) == 4


def test_search_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        autotune_flash_attention(1, 2, 64, 16, table=AutotuneTable(None))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        autotune_flash_attention(1, 2, 64, 16, torch.float16, table=AutotuneTable(None),
                                 device="cpu")


def _fake_timer(seconds):
    seq = iter(seconds)
    calls = []

    def fake(fn, *, trials):
        calls.append(trials)
        return next(seq)

    return fake, calls


def test_regression_guard_keeps_the_static_winner(monkeypatch):
    """A "winner" measured slower than the static choice must not displace
    it; a faster candidate does. The timer is faked, keyed on the candidate
    order (32, 128, then the static 64)."""
    cands = [(32, 64), (128, 64), (64, 64)]
    args = (1, 2, 128, 16, torch.bfloat16, False, cands, (64, 64), 3, False,
            torch.device("cpu"))
    fake, calls = _fake_timer([0.5e-6, 0.6e-6, 0.4e-6])
    monkeypatch.setattr(AT, "_time_best_of", fake)
    trials = AT.METRICS["tdl_autotune_trials_total"]["flash_attention"]
    e = AT._measure(*args)
    assert (e["block_q"], e["block_k"], e["measured"]) == (64, 64, True)
    assert e["candidates_us"] == {"32": 0.5, "128": 0.6, "64": 0.4}
    assert e["static_us"] == e["best_us"] == 0.4 and calls == [3, 3, 3]
    assert AT.METRICS["tdl_autotune_trials_total"]["flash_attention"] == trials + 9
    monkeypatch.setattr(AT, "_time_best_of", _fake_timer([0.5e-6, 0.1e-6, 0.4e-6])[0])
    e = AT._measure(*args)
    assert (e["block_q"], e["best_us"], e["static_us"]) == (128, 0.1, 0.4)


@pytest.mark.parametrize("include_backward", [False, True])
def test_the_timed_runs_go_through_flash_attention(include_backward, monkeypatch):
    """What the search times: flash_attention with each candidate's tile,
    and with ``include_backward`` its gradients too (here on the CPU, where
    the plain versions run)."""
    seen, grads = [], []
    apply = A.FlashAttentionFunction.apply
    monkeypatch.setattr(A.FlashAttentionFunction, "apply",
                        lambda *a: seen.append(a[-1]) or apply(*a))

    def run_once(fn, *, trials):
        out = fn()
        grads.append(isinstance(out, tuple) and len(out) == 3)
        return 1e-6 * (len(seen) + 1)

    monkeypatch.setattr(AT, "_time_best_of", run_once)
    e = AT._measure(1, 2, 32, 16, torch.float32, True, [(16, 64), (32, 64)], (16, 64), 2,
                    include_backward, torch.device("cpu"))
    assert seen == [16, 32] and grads == [include_backward] * 2
    assert e["block_q"] == 16 and e["measured"]


def test_a_candidate_that_fails_to_launch_raises(monkeypatch):
    def boom(fn, *, trials):
        raise RuntimeError("tdl_flash_fwd launch failed: too many resources requested")

    monkeypatch.setattr(AT, "_time_best_of", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        AT._measure(1, 2, 128, 16, torch.bfloat16, False, [(32, 64), (64, 64)], (64, 64),
                    3, False, torch.device("cpu"))


# --------------------------------------------------------------- the table


def test_table_round_trips_and_writes_atomically(tmp_path):
    path = tmp_path / "sub" / "autotune_cuda.json"
    t = AutotuneTable(str(path), device="NVIDIA H100 80GB HBM3")
    key = shape_key("flash_attention", B=8, H=12, Tq=128, Tk=128, D=64, dtype="bfloat16")
    entry = {"block_q": 128, "block_k": 64, "measured": True, "best_us": 10.5,
             "static_us": 10.9, "trials": 20, "candidates_us": {"32": 11.6, "64": 10.9,
                                                                "128": 10.5}}
    t.record(key, entry)
    data = json.loads(path.read_text())
    assert data == {"version": 1, "backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
                    "entries": {key: entry}}
    assert [p.name for p in path.parent.iterdir()] == ["autotune_cuda.json"]  # no temp left
    again = AutotuneTable(str(path), device="NVIDIA H100 80GB HBM3")
    assert len(again) == 1 and again.lookup(key) == entry
    assert again.resolve("flash_attention", 8, 12, 128, 128, 64, "bfloat16", 132) == (
        128, 64, "table")
    assert again.lookup("nothing") is None
    AutotuneTable(None).save()  # a table without a path writes nothing


def test_corrupt_and_other_card_tables_start_empty(tmp_path, caplog):
    path = tmp_path / "autotune_cuda.json"
    key = shape_key("flash_attention", B=8, H=12, Tq=128, Tk=128, D=64, dtype="bfloat16")
    caplog.set_level(logging.WARNING, logger=AT.__name__)
    path.write_text("{ not json")
    assert len(AutotuneTable(str(path), device="NVIDIA H100 80GB HBM3")) == 0
    path.write_text(json.dumps({"version": 1, "backend": "cuda", "device": "NVIDIA A100",
                                "entries": {key: {"block_q": 128, "block_k": 64}}}))
    other = AutotuneTable(str(path), device="NVIDIA H100 80GB HBM3")
    assert len(other) == 0 and "NVIDIA A100" in caplog.text
    assert other.resolve("flash_attention", 8, 12, 128, 128, 64, "bfloat16", 132)[2] == "static"
    assert len(AutotuneTable(str(path), device="NVIDIA A100")) == 1
    path.write_text(json.dumps({"version": 2, "backend": "cuda", "entries": {}}))
    assert len(AutotuneTable(str(path))) == 0
    # an entry with a tile the kernel does not have answers like no entry
    t = AutotuneTable(None)
    t.record(key, {"block_q": 48, "block_k": 64}, persist=False)
    assert t.resolve("flash_attention", 8, 12, 128, 128, 64, "bfloat16", 132) == (
        64, 64, "static")


def test_resolution_is_memoised_until_a_record(tmp_path):
    t = AutotuneTable(None)
    args = ("flash_attention", 1, 12, 512, 512, 64, "float32", 132)
    assert t.resolve(*args) == (16, 64, "static")
    key = shape_key("flash_attention", B=1, H=12, Tq=512, Tk=512, D=64, dtype="float32")
    t._entries[key] = {"block_q": 32, "block_k": 64}  # behind the memo's back
    assert t.resolve(*args) == (16, 64, "static")
    t.record(key, {"block_q": 32, "block_k": 64}, persist=False)
    assert t.resolve(*args) == (32, 64, "table")


def test_default_table_is_found_by_the_environment_when_made(tmp_path, monkeypatch):
    monkeypatch.delenv(AT.ENV_DIR, raising=False)
    monkeypatch.setenv("TDL_TORCH_BUILD_DIR", str(tmp_path / "build"))
    AT.reset_table()
    try:
        assert AT.default_table_path() == str(tmp_path / "build" / "autotune_cuda.json")
        t = AT.get_table()
        assert AT.get_table() is t and t.path == AT.default_table_path()
        # the environment is read when the table is made, not on each lookup
        monkeypatch.setenv(AT.ENV_DIR, str(tmp_path / "at"))
        assert AT.get_table() is t
        AT.reset_table()
        t2 = AT.get_table()
        assert t2 is not t and t2.path == str(tmp_path / "at" / "autotune_cuda.json")
        t2.record("k", {"block_q": 32, "block_k": 64})
        assert AT.METRICS["tdl_autotune_table_entries"] == 1
        assert AT.get_table(refresh=True) is not t2 and len(AT.get_table()) == 1
    finally:
        AT.reset_table()


# --------------------------------------------------------- flash consults


def test_flash_attention_consults_the_table_and_stays_correct(tmp_table_dir, monkeypatch):
    table = AT.get_table()
    assert table.path == str(tmp_table_dir / "autotune_cuda.json")
    key = shape_key("flash_attention", B=2, H=2, Tq=64, Tk=64, D=16, dtype="float32")
    table.record(key, {"block_q": 32, "block_k": 64, "measured": True})
    seen = []
    apply = A.FlashAttentionFunction.apply
    monkeypatch.setattr(A.FlashAttentionFunction, "apply",
                        lambda *a: seen.append(a[-1]) or apply(*a))
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(2, 2, 64, 16).astype(np.float32)) for _ in range(3))
    before = _lookups("table")
    out = A.flash_attention(q, k, v)
    assert _lookups("table") == before + 1 and seen == [32]
    np.testing.assert_allclose(out.numpy(), A.mha_reference(q, k, v).numpy(), atol=ATOL)
    # an explicit tile bypasses the table (no lookup) and gives the same result
    out16 = A.flash_attention(q, k, v, block_q=16, block_k=64)
    assert _lookups("table") == before + 1 and seen == [32, 16]
    assert torch.equal(out16, out)
    # a shape with no entry takes the static table
    static = _lookups("static")
    A.flash_attention(q[:, :, :16], k, v, causal=True)
    assert _lookups("static") == static + 1 and seen[-1] == 16


def test_bad_tiles_raise():
    rs = np.random.RandomState(1)
    for dtype, bad in ((torch.float32, 64), (torch.float32, 8), (torch.bfloat16, 16),
                       (torch.bfloat16, 48)):
        q = torch.from_numpy(rs.randn(1, 2, 32, 16).astype(np.float32)).to(dtype)
        with pytest.raises(ValueError, match="q-tiles of"):
            A.flash_attention(q, q, q, block_q=bad)
        with pytest.raises(ValueError, match="k-tile is 64"):
            A.flash_attention(q, q, q, block_k=128)
    for dtype, rows in AT.FWD_Q_ROWS.items():
        q = torch.from_numpy(rs.randn(1, 2, 32, 16).astype(np.float32)).to(getattr(torch, dtype))
        ref = A.flash_attention(q, q, q, block_q=rows[0])
        for r in rows[1:]:  # the plain version does not depend on the tile
            assert torch.equal(A.flash_attention(q, q, q, block_q=r, block_k=64), ref)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows", [(dt, r) for dt, rs in AT.FWD_Q_ROWS.items() for r in rs])
def test_each_tile_height_matches_the_plain_version_on_the_card(dtype, rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(rows)
    for B, H, T, causal in ((2, 4, 77, True), (2, 12, 128, False), (1, 12, 300, True)):
        q, k, v = (torch.from_numpy(rs.randn(B, H, T, 64).astype(np.float32)).to("cuda", dt)
                   for _ in range(3))
        before = A.flash_forward.launches_by_q_rows[(dtype, rows)]
        out, lse = A.flash_forward(q, k, v, None, None, causal, 0.125, 0, rows)
        assert A.flash_forward.launches_by_q_rows[(dtype, rows)] == before + 1
        ref, ref_lse = A.flash_forward_reference(q, k, v, None, None, causal, 0.125, 0)
        if dt == torch.float32:
            assert (out - ref).abs().max().item() <= 2e-5
        else:
            tol = 2.0 ** -7 * ref.float().abs() + 1e-5
            assert bool(((out.float() - ref.float()).abs() <= tol).all())
        assert bool(((lse - ref_lse).abs() <= 1e-5 * ref_lse.abs().clamp(min=1.0)).all())
