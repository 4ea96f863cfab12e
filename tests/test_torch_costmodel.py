"""The port's cost observatory, SLOs and the history / aggregate helpers they
read, against the JAX package's.

- ``cost_table`` / ``publish`` give the JAX package's table and gauges for
  equal rows (equal, key for key);
- the counted step (``xla_step_cost``: fake tensors under
  ``FlopCounterMode``) changes no tensor of the network, and its flops are
  checked against arithmetic written out here: LeNet's exactly; the flash
  operators' formulas exactly; a 2-layer transformer's coverage in
  [0.9, 1.1];
- the XLA keys the port cannot compute are listed and absent;
- the SLO tracker gives the JAX package's rows for the same registry
  history (attainment, budget and burn within 1e-12);
- ``count_at_or_below`` and ``merged_snapshot`` equal the JAX package's.
"""

import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitoring as JM
from deeplearning4j_tpu.models import zoo as JZ
from deeplearning4j_tpu.monitoring import aggregate as JAgg
from deeplearning4j_tpu.monitoring import costmodel as JCost
from deeplearning4j_tpu.monitoring import history as JHist
from deeplearning4j_tpu_torch import monitoring as TM
from deeplearning4j_tpu_torch.kernels import attention as TA
from deeplearning4j_tpu_torch.models import transformer as T
from deeplearning4j_tpu_torch.models import zoo as TZ
from deeplearning4j_tpu_torch.monitoring import aggregate as TAgg
from deeplearning4j_tpu_torch.monitoring import costmodel as TCost
from deeplearning4j_tpu_torch.monitoring import history as THist
from deeplearning4j_tpu_torch.nn import updaters as TU
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

SLO_ATOL = 1e-12  # the same float arithmetic on the same counts
#: XLA's keys of the JAX package's ``xla_step_cost`` that the port has no
#: counterpart for: left out of the dict, never filled with 0
ABSENT_KEYS = ("bytes_accessed", "transcendentals", "argument_bytes", "output_bytes",
               "temp_bytes", "alias_bytes", "peak_bytes")


def _lenet_batch(B, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.rand(B, 1, 28, 28).astype(np.float32)),
            torch.from_numpy(np.eye(10, dtype=np.float32)[rs.randint(0, 10, B)]))


def _padded_conv(B, hw, c_in, c_out, k):
    """2·MACs of a stride-1 SAME convolution computed over its padded input."""
    return 2 * B * hw * hw * c_out * c_in * k * k


def test_cost_table_and_publish_equal_jax():
    jnet = JZ.LeNet().init()
    tnet = TZ.LeNet().init(device="cpu")
    rows = TCost.layer_costs(tnet, 128)
    assert rows == JCost.layer_costs(jnet, 128)
    for xla in (None, {"flops": 7.5e8}, {"flops": 7.5e8, "peak_bytes": 123}):
        treg, jreg = TM.MetricsRegistry(), JM.MetricsRegistry()
        assert TCost.publish("lenet", rows, xla, registry=treg) == \
            JCost.publish("lenet", rows, xla, registry=jreg)
        # the series, labels and types; the help texts say what each package counts
        strip = lambda snap: {f: {k: v for k, v in fam.items() if k != "help"}  # noqa: E731
                              for f, fam in snap.items()}
        assert strip(treg.snapshot()) == strip(jreg.snapshot())
    assert TCost.cost_table(rows, {"flops": 1e9})["coverage"] == \
        JCost.cost_table(rows, {"flops": 1e9})["coverage"]


def test_lenet_step_count_is_exact_and_leaves_the_network_alone():
    """LeNet's counted train step is its products over the padded inputs:
    conv 1 (its dX skipped: the input needs no gradient), conv 2, dense 500
    and the output layer, forward and backward. Pinned difference: the
    layer estimate (the JAX package's, like XLA) counts only the taps inside
    the image, so coverage is 0.8909 here, below the JAX gate of 0.9 that
    XLA's count meets (0.9847 on this host): the port's convolutions run on
    an explicitly SAME-padded input, and the card does those taps."""
    B = 16
    net = TZ.LeNet().init(device="cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    upd_before = {k: {n: t.clone() for n, t in v.items()} for k, v in net.updater_state.items()}
    x, y = _lenet_batch(B)
    counts = TCost.step_flop_counts(net, x, y, None, None, 0)
    conv1 = _padded_conv(B, 28, 1, 20, 5)
    conv2 = _padded_conv(B, 14, 20, 50, 5)
    dense = 2 * B * (7 * 7 * 50 * 500 + 500 * 10)
    assert counts == {"aten.convolution": conv1 + conv2,
                      "aten.convolution_backward": conv1 + 2 * conv2,
                      "aten.mm": 3 * dense}
    xla = TCost.xla_step_cost(net, x, y, None, None, 0)
    assert xla == {"flops": float(sum(counts.values()))}
    assert not set(ABSENT_KEYS) & set(xla)
    table = TCost.cost_table(TCost.layer_costs(net, B), xla)
    assert table["coverage"] == round(table["total_flops"] / xla["flops"], 4) == 0.8909
    assert net.iteration == 0
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())
    for k, v in net.updater_state.items():
        assert all(torch.equal(upd_before[k][n], t) for n, t in v.items())


def _flat(tree, path="", out=None):
    out = {} if out is None else out
    if isinstance(tree, torch.Tensor):
        out[path] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{path}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{path}/{i}", out)
    elif hasattr(tree, "__dict__"):
        _flat(vars(tree), path, out)
    return out


def _small_transformer():
    kw = dict(vocab_size=97, max_len=64, d_model=128, n_heads=2, n_layers=2, d_ff=512,
              dropout=0.0)
    cfg = T.TransformerConfig(compute_dtype=torch.float32, **kw)
    params = T.init_params(0, cfg, device="cpu")
    rs = np.random.RandomState(1)
    B, L, P = 4, 64, 10
    batch = {"tokens": rs.randint(0, 97, (B, L)).astype(np.int32),
             "segments": np.zeros((B, L), np.int32),
             "pad_mask": np.ones((B, L), np.float32),
             "mlm_positions": np.stack([np.sort(rs.choice(L, P, replace=False))
                                        for _ in range(B)]).astype(np.int32),
             "labels": rs.randint(0, 97, (B, P)).astype(np.int32),
             "weights": np.ones((B, P), np.float32)}
    return cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}, (B, L, P)


def test_transformer_step_coverage_and_no_state_change():
    cfg, params, batch, (B, L, P) = _small_transformer()
    upd = TU.Adam(1e-3)
    opt = upd.init(params)
    snap = {k: v.clone() for k, v in _flat({"p": params, "o": opt}).items()}
    step = T.make_train_step(cfg, upd)
    xla = TCost.xla_step_cost(step, params, opt, batch, 0)
    table = TCost.cost_table(T.layer_costs(cfg, B, L, mlm_positions=P), xla)
    assert 0.9 <= table["coverage"] <= 1.1, table["coverage"]
    now = _flat({"p": params, "o": opt})
    assert snap.keys() == now.keys()
    assert all(torch.equal(snap[k], v) for k, v in now.items())


def test_flash_operator_flop_formulas():
    """The three flash operators count through the registered formulas: per
    live (query, key) pair and head dim D, 4D forward, 8D dkv, 6D dq plus
    2D per query row for delta; causal calls count the live triangle."""
    TCost.register_flash_flop_formulas()
    rs = np.random.RandomState(2)
    B, H, Tq, Tk, D = 2, 3, 16, 24, 8
    q = torch.from_numpy(rs.randn(B, H, Tq, D).astype(np.float32))
    k = torch.from_numpy(rs.randn(B, H, Tk, D).astype(np.float32))
    v = torch.from_numpy(rs.randn(B, H, Tk, D).astype(np.float32))

    def fwd_bwd(q, k, v, causal):
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = TA.flash_attention(q, k, v, causal=causal)
        torch.autograd.grad(out.sum(), (q, k, v))

    for causal in (False, True):
        counts = TCost.step_flop_counts(fwd_bwd, q, k, v, causal)
        pairs = Tq * Tk if not causal else sum(min(Tk, i + (Tk - Tq) + 1) for i in range(Tq))
        assert counts == {"tdl.flash_fwd": 4 * B * H * D * pairs,
                          "tdl.flash_bwd_dkv": 8 * B * H * D * pairs,
                          "tdl.flash_bwd_dq": 6 * B * H * D * pairs + 2 * B * H * Tq * D}


def test_live_hbm_breakdown_pins_other_to_the_allocator():
    """Pinned difference: JAX walks ``jax.live_arrays()`` into "other"; the
    port puts ``torch.cuda.memory_allocated()`` less the trees' card bytes
    there, which is 0 on the CPU. A tensor named by two trees counts once,
    for the first."""
    net = TZ.LeNet().init(device="cpu")
    reg = TM.MetricsRegistry()
    got = TCost.net_hbm_breakdown(net, model="lenet", registry=reg)
    p_bytes = sum(p.numel() * 4 for p in net.parameters())
    assert got == {"params": p_bytes, "opt_state": 2 * p_bytes, "bn_state": 0, "other": 0}
    series = {s["labels"]["kind"]: s["value"]
              for s in reg.get("tdl_hbm_bytes").snapshot()["series"]}
    assert series == {k: float(v) for k, v in got.items()}
    w = torch.ones(10)
    assert TCost.live_hbm_breakdown({"a": [w], "b": {"x": w, "y": torch.ones(3)}}) == \
        {"a": 40, "b": 12, "other": 0}


# ------------------------------------------------------------------- SLOs


def _history_pair():
    """The same observations into a registry of each package, sampled into
    a history ring after each of three rounds."""
    out = {}
    for tag, M in (("torch", TM), ("jax", JM)):
        reg = M.MetricsRegistry()
        lat = reg.histogram("tdl_inference_latency_seconds", buckets=(0.05, 0.1, 0.25, 1.0))
        req = reg.counter("tdl_inference_requests_total", labels=("code",))
        cli = reg.histogram("tdl_client_request_seconds", labels=("outcome",),
                            buckets=(0.05, 0.1, 0.25, 1.0))
        ring = M.HistoryRing(registry=reg, interval=0.0)
        ring.sample(force=True)
        rs = np.random.RandomState(4)
        for rnd in range(3):
            for v in rs.exponential(0.06 * (1 + rnd), 200):
                lat.observe(float(v))
                cli.labels("ok").observe(float(v) * 1.2)
            for code, n in (("200", 180 - 20 * rnd), ("429", 5 * rnd), ("504", rnd)):
                if n:
                    req.labels(code).inc(n)
            time.sleep(0.002)
            ring.sample(force=True)
        out[tag] = (M, reg, ring)
    return out


def test_slo_tracker_rows_equal_jax():
    pair = _history_pair()
    rows = {}
    for tag, (M, reg, ring) in pair.items():
        tracker = M.SloTracker(M.default_objectives(latency_threshold_s=0.1, target=0.95,
                                                    window_s=60.0),
                               history_view=ring, registry=reg,
                               burn_windows=(("fast", 30.0), ("slow", 120.0)))
        rows[tag] = tracker.evaluate()
        rows[tag + "_gauges"] = {f: sorted((tuple(sorted(s["labels"].items())), s["value"])
                                           for s in reg.get(f).snapshot()["series"])
                                 for f in ("tdl_slo_attainment", "tdl_slo_burn_rate",
                                           "tdl_slo_error_budget_remaining")}
    assert len(rows["torch"]) == 3
    for got, want in zip(rows["torch"], rows["jax"]):
        for key in ("slo", "family", "threshold_seconds", "target", "window", "state"):
            assert got[key] == want[key]
        for key in ("attainment", "error_budget_remaining"):
            assert abs(got[key] - want[key]) <= SLO_ATOL, (got["slo"], key)
        for w in ("fast", "slow"):
            assert abs(got["burn_rate"][w] - want["burn_rate"][w]) <= SLO_ATOL
    assert "violating" in {r["state"] for r in rows["torch"]}
    for fam, series in rows["torch_gauges"].items():
        want = rows["jax_gauges"][fam]
        assert [k for k, _ in series] == [k for k, _ in want]
        assert max(abs(a[1] - b[1]) for a, b in zip(series, want)) <= SLO_ATOL
    assert [o.to_dict() for o in TM.default_objectives()] == \
        [o.to_dict() for o in JM.default_objectives()]


def test_slo_tracker_self_feeds_and_reports_no_traffic():
    reg = TM.MetricsRegistry()
    tracker = TM.SloTracker(registry=reg)
    rows = tracker.evaluate()
    assert {r["state"] for r in rows} == {"no_traffic"}
    assert all(r["error_budget_remaining"] == 1.0 for r in rows)
    with pytest.raises(ValueError, match="exactly one of"):
        TM.SloObjective("x")


@pytest.mark.parametrize("seed", range(4))
def test_count_at_or_below_equals_jax(seed):
    rs = np.random.RandomState(seed)
    edges = np.sort(rs.uniform(0.001, 2.0, 6))
    buckets = {float(e): float(rs.randint(0, 50)) for e in edges}
    for th in list(edges) + list(rs.uniform(0, 2.5, 10)) + [0.0, 5.0]:
        assert THist.count_at_or_below(buckets, float(th)) == \
            JHist.count_at_or_below(buckets, float(th))
    assert THist.count_at_or_below({}, 1.0) == 0.0


def test_merged_snapshot_equals_jax(tmp_path):
    d = str(tmp_path / "spool")
    for rank, (M, Agg) in enumerate(((TM, TAgg), (JM, JAgg))):
        reg = M.MetricsRegistry()
        h = reg.histogram("tdl_step_wall_seconds", buckets=(0.01, 0.1, 1.0))
        for v in (0.02, 0.05, 0.3 * (rank + 1)):
            h.observe(v)
        reg.counter("tdl_iterations_total", labels=("model",)).labels("m").inc(3)
        Agg.MetricsSpooler(d, proc=f"rank{rank}", registry=reg, rank=rank).spool(force=True)
    got = TAgg.merged_snapshot(d)
    want = JAgg.merged_snapshot(d)
    assert got == want
    assert set(got["procs"]) == {"rank0", "rank1"} and got["derived"]["slowest_rank"] == 1
    local = TM.MetricsRegistry()
    local.gauge("tdl_x", "x").set(1.0)
    assert TAgg.merged_snapshot(d, local_registry=local)["local"] == local.snapshot()
    assert TAgg.DERIVED_FAMILIES == JAgg.DERIVED_FAMILIES
