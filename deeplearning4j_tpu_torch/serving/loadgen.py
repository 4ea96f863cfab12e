"""Trace-replay load generator — realistic traffic, measured client-side
(copy of the JAX package's ``serving.loadgen``: the same seed gives the same
arrival schedule and prompts in both packages).

Steady-state p99 under a constant closed loop is the flattering number:
production traffic has a diurnal curve, Poisson arrival jitter, bursts, and
deadline diversity — and the ONLY honest place to measure what users got is
the client. So the serving stack is judged against replayed realistic load,
never assumed steady state.

- :class:`TraceSpec` is a deterministic (seeded) trace recipe: a base
  request rate shaped by a sinusoidal diurnal curve, stacked
  :class:`Burst` segments (the 10× spike), Poisson arrivals via thinning,
  and a weighted deadline mix. Same seed → byte-identical arrival
  schedule, so replays are comparable across runs/machines. JSON-able
  (``to_dict``/``from_dict``) so bench configs and files can carry it.
- :class:`LoadGenerator` replays a spec against a ``JsonModelServer``
  through N client threads, open-loop up to a concurrency bound of
  ``n_clients``: arrivals are sent at their scheduled offsets whether or
  not earlier responses came back, until all workers are blocked in
  flight — beyond that the replay degrades toward closed-loop and the
  report's ``lateness_ms`` percentiles say by how much (large lateness =
  the generator, not the server, was the bottleneck; size ``n_clients``
  ≥ peak_rate × worst-case latency to keep the schedule honest). Latency
  is measured client-side per request (retries disabled — each arrival
  maps 1:1 to an outcome), outcomes bucketed by HTTP code, and the report
  carries SLO attainment, error-budget remaining and burn rate computed
  from the client-side truth.

Request ids are deterministic (``{prefix}-{index}``) and ride
``X-Request-Id``, so any replayed request joins against the server's
``request_span`` flight events and its history ring — a replay plus one merge
reconstructs any request's queue→infer→serialize life.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .json_server import JsonModelClient

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Burst:
    """One burst segment: the arrival rate is multiplied by ``multiplier``
    for ``duration_s`` starting at ``start_s`` into the replay."""

    start_s: float
    duration_s: float
    multiplier: float = 10.0

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.start_s + self.duration_s


@dataclass(frozen=True)
class TraceSpec:
    """Deterministic replay recipe.

    ``rate(t) = base_rate * (1 + diurnal_amplitude * sin(2πt/period + phase))
    * (product of active burst multipliers)`` — the diurnal term compresses
    a day's load curve into ``diurnal_period_s`` seconds. ``deadline_mix``
    is ``((weight, deadline_ms | None), ...)``: each arrival draws its
    deadline from the mix (None = server default), so shed behavior under
    pressure is part of the replay, not a separate test.

    **Shared-prefix request mix.** Generative serving with a
    paged KV cache pays for a common system prompt ONCE via copy-on-write
    prefix sharing — so the trace must be able to offer that shape of
    traffic. With ``prefix_tenants > 0``, :meth:`prompt_fn` deterministically
    assigns arrival ``i`` to tenant ``i % prefix_tenants``; its prompt is
    the tenant's fixed ``prefix_len``-token system prompt followed by
    ``suffix_len`` per-request unique tokens (ids in ``[1, prompt_vocab)``
    — 0 is avoided so a server-side EOS/pad convention cannot truncate the
    replay). Same seed → byte-identical prompts, so CoW savings measured
    under replay are reproducible."""

    duration_s: float = 10.0
    base_rate: float = 50.0
    seed: int = 0
    diurnal_amplitude: float = 0.0
    diurnal_period_s: Optional[float] = None
    diurnal_phase: float = -math.pi / 2  # start at the trough: ramp up first
    bursts: Tuple[Burst, ...] = ()
    deadline_mix: Tuple[Tuple[float, Optional[float]], ...] = ((1.0, None),)
    prefix_tenants: int = 0  # 0 = no shared-prefix mix (feature off)
    prefix_len: int = 32
    suffix_len: int = 8
    prompt_vocab: int = 256

    def __post_init__(self):
        if self.duration_s <= 0 or self.base_rate <= 0:
            raise ValueError("duration_s and base_rate must be > 0")
        if not (0.0 <= self.diurnal_amplitude < 1.0):
            raise ValueError("diurnal_amplitude must be in [0, 1) — an "
                             "amplitude of 1 stalls the trace at the trough")
        object.__setattr__(self, "bursts", tuple(
            b if isinstance(b, Burst) else Burst(*b) for b in self.bursts))
        mix = tuple((float(w), None if d is None else float(d))
                    for w, d in self.deadline_mix)
        if not mix or any(w <= 0 for w, _ in mix):
            raise ValueError("deadline_mix needs positive weights")
        object.__setattr__(self, "deadline_mix", mix)
        if self.prefix_tenants < 0:
            raise ValueError("prefix_tenants must be >= 0")
        if self.prefix_tenants:
            if self.prefix_len < 1 or self.suffix_len < 1:
                raise ValueError("prefix_len and suffix_len must be >= 1 "
                                 "when prefix_tenants > 0")
            if self.prompt_vocab < 2:
                raise ValueError("prompt_vocab must be >= 2 (ids are drawn "
                                 "from [1, prompt_vocab))")

    # -- shared-prefix prompts ---------------------------------------------

    def prompt_fn(self) -> Callable[[int], List[int]]:
        """Deterministic ``index -> token list`` for the shared-prefix mix
        (``prefix_tenants`` must be > 0) — pass it as a ``LoadGenerator``
        ``payload_fn`` or feed it to the bench's executor replay. The
        per-tenant system prompts are fixed for the whole trace; suffixes
        are unique per request index. Pure function of the spec: same
        seed, same prompts, any machine."""
        if not self.prefix_tenants:
            raise ValueError("prompt_fn needs prefix_tenants > 0 — this "
                             "spec has no shared-prefix mix")
        prefix_rng = np.random.default_rng([int(self.seed), 0x5e9])
        prefixes = [prefix_rng.integers(
            1, self.prompt_vocab, size=self.prefix_len).tolist()
            for _ in range(self.prefix_tenants)]

        def fn(i: int) -> List[int]:
            suffix_rng = np.random.default_rng([int(self.seed), 0xd1f, int(i)])
            suffix = suffix_rng.integers(
                1, self.prompt_vocab, size=self.suffix_len).tolist()
            return prefixes[i % self.prefix_tenants] + suffix

        return fn

    # -- rate curve --------------------------------------------------------

    def rate_at(self, t: float) -> float:
        period = self.diurnal_period_s or self.duration_s
        rate = self.base_rate * (
            1.0 + self.diurnal_amplitude
            * math.sin(2 * math.pi * t / period + self.diurnal_phase))
        for b in self.bursts:
            if b.active(t):
                rate *= b.multiplier
        return max(0.0, rate)

    @property
    def peak_rate(self) -> float:
        peak = self.base_rate * (1.0 + self.diurnal_amplitude)
        mult = 1.0
        for b in self.bursts:  # bursts may overlap: bound by the product
            mult *= max(1.0, b.multiplier)
        return peak * mult

    # -- arrivals ----------------------------------------------------------

    def arrivals(self) -> List[Tuple[float, Optional[float]]]:
        """The full deterministic schedule: ``[(t_offset_s, deadline_ms),
        ...]`` — an inhomogeneous Poisson process via thinning (candidates
        at the peak rate, accepted with probability rate(t)/peak), each
        arrival drawing its deadline from the mix. Pure function of the
        spec: same seed, same schedule, any machine."""
        rng = np.random.default_rng(self.seed)
        peak = self.peak_rate
        weights = np.asarray([w for w, _ in self.deadline_mix])
        weights = weights / weights.sum()
        deadlines = [d for _, d in self.deadline_mix]
        out: List[Tuple[float, Optional[float]]] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= self.duration_s:
                return out
            if rng.random() * peak <= self.rate_at(t):
                out.append((t, deadlines[int(rng.choice(len(deadlines),
                                                        p=weights))]))

    # -- serialization (bench configs / trace files) -----------------------

    def to_dict(self) -> dict:
        return {
            "duration_s": self.duration_s,
            "base_rate": self.base_rate,
            "seed": self.seed,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period_s": self.diurnal_period_s,
            "diurnal_phase": self.diurnal_phase,
            "bursts": [[b.start_s, b.duration_s, b.multiplier]
                       for b in self.bursts],
            "deadline_mix": [list(p) for p in self.deadline_mix],
            "prefix_tenants": self.prefix_tenants,
            "prefix_len": self.prefix_len,
            "suffix_len": self.suffix_len,
            "prompt_vocab": self.prompt_vocab,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSpec":
        kw = dict(d)
        kw["bursts"] = tuple(Burst(*b) for b in kw.get("bursts", ()))
        kw["deadline_mix"] = tuple(
            (w, dl) for w, dl in kw.get("deadline_mix", ((1.0, None),)))
        return cls(**kw)


def _percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class LoadGenerator:
    """Replay of a :class:`TraceSpec` against a JSON model server —
    open-loop up to ``n_clients`` concurrent requests (see the module
    docstring for the fidelity contract; ``lateness_ms`` in the report is
    the honesty check).

    ``payload`` may be a jsonable value sent with every request or a
    callable ``index -> jsonable``. ``slo_threshold_ms``/``slo_target``
    parameterize the report's client-side SLO math (good = HTTP 200 within
    the threshold; every non-200 outcome burns budget — a shed request IS
    a user-visible failure). ``record_requests=True`` additionally returns
    the per-request ``(request_id, outcome, latency_ms, t_offset)`` rows
    for span joins in tests/postmortems.
    """

    def __init__(self, spec: TraceSpec, port: int, host: str = "127.0.0.1",
                 endpoint: str = "/predict", n_clients: int = 8,
                 payload: Any = None,
                 payload_fn: Optional[Callable[[int], Any]] = None,
                 request_id_prefix: str = "replay",
                 slo_threshold_ms: float = 250.0, slo_target: float = 0.99,
                 burn_window_s: float = 1.0, timeout: float = 30.0,
                 record_requests: bool = False, registry=None):
        if n_clients < 1:
            raise ValueError("n_clients must be >= 1")
        self.spec = spec
        self.host, self.port, self.endpoint = host, port, endpoint
        self.n_clients = n_clients
        self.payload = payload if payload is not None else [[0.0]]
        self.payload_fn = payload_fn
        self.request_id_prefix = request_id_prefix
        self.slo_threshold_ms = slo_threshold_ms
        self.slo_target = slo_target
        self.burn_window_s = burn_window_s
        self.timeout = timeout
        self.record_requests = record_requests
        self.registry = registry

    def _client(self) -> JsonModelClient:
        # retries=0: open loop maps each scheduled arrival to exactly one
        # outcome — a retried 429 would hide the shed the SLO must see
        return JsonModelClient(host=self.host, port=self.port,
                               endpoint=self.endpoint, timeout=self.timeout,
                               retries=0, breaker_threshold=10 ** 9,
                               registry=self.registry)

    @staticmethod
    def _classify(err_msg: str) -> str:
        for code in ("429", "503", "504", "500", "400", "413"):
            if f"HTTP {code}" in err_msg:
                return code
        return "error"

    def run(self) -> dict:
        """Replay the whole spec; returns the machine-readable SLO report."""
        arrivals = self.spec.arrivals()
        results: List[Optional[dict]] = [None] * len(arrivals)
        next_idx = [0]
        idx_lock = threading.Lock()
        t0 = time.perf_counter()

        def worker():
            client = self._client()
            while True:
                with idx_lock:
                    i = next_idx[0]
                    if i >= len(arrivals):
                        return
                    next_idx[0] = i + 1
                sched_t, deadline_ms = arrivals[i]
                delay = sched_t - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                rid = f"{self.request_id_prefix}-{self.spec.seed}-{i}"
                payload = (self.payload_fn(i) if self.payload_fn is not None
                           else self.payload)
                sent = time.perf_counter()
                try:
                    client.predict(payload, deadline_ms=deadline_ms,
                                   request_id=rid)
                    outcome = "200"
                except RuntimeError as e:
                    outcome = self._classify(str(e))
                latency = time.perf_counter() - sent
                results[i] = {"request_id": rid, "outcome": outcome,
                              "latency_ms": latency * 1e3,
                              "t": sched_t,
                              "lateness_ms": (sent - t0 - sched_t) * 1e3}

        threads = [threading.Thread(target=worker, name=f"tdl-loadgen-{i}",
                                    daemon=True) for i in range(self.n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        return self._report([r for r in results if r is not None], elapsed)

    # -- report ------------------------------------------------------------

    def _report(self, rows: List[dict], elapsed: float) -> dict:
        outcomes: Dict[str, int] = {}
        for r in rows:
            outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
        ok_lat = sorted(r["latency_ms"] for r in rows
                        if r["outcome"] == "200")
        lateness = sorted(r["lateness_ms"] for r in rows)
        total = len(rows)
        good = sum(1 for r in rows if r["outcome"] == "200"
                   and r["latency_ms"] <= self.slo_threshold_ms)
        allowed = 1.0 - self.slo_target
        attainment = good / total if total else None
        # burn over trailing sub-windows: the WORST window is what a
        # multi-window alert pair would have seen mid-replay
        worst_burn, burn_series = 0.0, []
        w = max(1e-9, self.burn_window_s)
        n_windows = max(1, int(math.ceil(self.spec.duration_s / w)))
        for k in range(n_windows):
            in_w = [r for r in rows if k * w <= r["t"] < (k + 1) * w]
            if not in_w:
                burn_series.append(None)
                continue
            g = sum(1 for r in in_w if r["outcome"] == "200"
                    and r["latency_ms"] <= self.slo_threshold_ms)
            burn = (1.0 - g / len(in_w)) / allowed
            burn_series.append(round(burn, 3))
            worst_burn = max(worst_burn, burn)
        report = {
            "spec": self.spec.to_dict(),
            "clients": self.n_clients,
            "offered": total,
            "offered_rate_per_s": round(total / elapsed, 2) if elapsed else 0,
            "elapsed_s": round(elapsed, 3),
            "outcomes": outcomes,
            "latency_ms": {
                "p50": _percentile(ok_lat, 0.50),
                "p90": _percentile(ok_lat, 0.90),
                "p99": _percentile(ok_lat, 0.99),
                "max": ok_lat[-1] if ok_lat else None,
            },
            # scheduling fidelity: large lateness means the generator (not
            # the server) was the bottleneck and the replay under-offered
            "lateness_ms": {"p50": _percentile(lateness, 0.50),
                            "p99": _percentile(lateness, 0.99)},
            "slo": {
                "threshold_ms": self.slo_threshold_ms,
                "target": self.slo_target,
                "good": good,
                "attainment": (round(attainment, 6)
                               if attainment is not None else None),
                "error_budget_remaining": (
                    round(1.0 - (1.0 - attainment) / allowed, 4)
                    if attainment is not None else None),
                "burn_rate_overall": (
                    round((1.0 - attainment) / allowed, 3)
                    if attainment is not None else None),
                "burn_rate_worst_window": round(worst_burn, 3),
                "burn_window_s": self.burn_window_s,
                "burn_rate_series": burn_series,
            },
        }
        if self.record_requests:
            report["requests"] = rows
        return report


def replay(spec: TraceSpec, port: int, **kw) -> dict:
    """One-call replay: ``replay(TraceSpec(...), server.port, ...)``."""
    return LoadGenerator(spec, port, **kw).run()
