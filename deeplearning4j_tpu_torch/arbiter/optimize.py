"""Parameter spaces, candidate generators, optimization runner.

Copy of the JAX package's ``arbiter/optimize.py`` (DL4J's
``org.deeplearning4j.arbiter.optimize``: ``api.ParameterSpace`` leaf
spaces, ``generator.{RandomSearchGenerator, GridSearchCandidateGenerator,
genetic.*}``, ``runner.LocalOptimizationRunner`` with score functions and
termination conditions). It is host numpy and holds no tensor; a seed
draws the same ``RandomState`` stream as the JAX package's, so both
packages' generators hand out the same candidates, which the trial fleet's
verdicts depend on.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class GeneratorExhausted(RuntimeError):
    """``next_candidate()`` on a generator with nothing left. Exhaustion is
    a normal terminal state for finite generators (grid) — callers poll
    ``has_more()`` — but an over-draw must fail loudly and typed, not with
    an ``IndexError`` from an implementation detail: a trial fleet pulling
    candidates from worker threads needs to tell 'the sweep is smaller than
    requested' from a genuine bug."""


# ----------------------------------------------------------- parameter spaces


class ParameterSpace:
    """Leaf space: maps a uniform u in [0,1) to a value."""

    def value(self, u: float):
        raise NotImplementedError

    def grid_points(self, n: int) -> List[Any]:
        return [self.value((i + 0.5) / n) for i in range(n)]


class ContinuousParameterSpace(ParameterSpace):
    def __init__(self, lo: float, hi: float, log_scale: bool = False):
        self.lo, self.hi, self.log_scale = lo, hi, log_scale

    def value(self, u: float) -> float:
        if self.log_scale:
            return float(math.exp(math.log(self.lo) + u * (math.log(self.hi) - math.log(self.lo))))
        return float(self.lo + u * (self.hi - self.lo))


class IntegerParameterSpace(ParameterSpace):
    def __init__(self, lo: int, hi: int):  # inclusive
        self.lo, self.hi = lo, hi

    def value(self, u: float) -> int:
        return int(min(self.hi, self.lo + math.floor(u * (self.hi - self.lo + 1))))

    def grid_points(self, n: int):
        span = self.hi - self.lo + 1
        if n >= span:
            return list(range(self.lo, self.hi + 1))
        return sorted({self.value((i + 0.5) / n) for i in range(n)})


class DiscreteParameterSpace(ParameterSpace):
    def __init__(self, *values):
        one_list = len(values) == 1 and isinstance(values[0], (list, tuple))
        self.values = list(values[0]) if one_list else list(values)

    def value(self, u: float):
        return self.values[min(len(self.values) - 1, int(u * len(self.values)))]

    def grid_points(self, n: int):
        return list(self.values)


class FixedValue(ParameterSpace):
    def __init__(self, v):
        self.v = v

    def value(self, u: float):
        return self.v

    def grid_points(self, n: int):
        return [self.v]


# ------------------------------------------------------- candidate generators


class CandidateGenerator:
    """Yields candidate dicts {param_name: value} over a named space dict."""

    def __init__(self, spaces: Dict[str, ParameterSpace], seed: int = 42):
        self.spaces = spaces
        self.rs = np.random.RandomState(seed)

    def has_more(self) -> bool:
        return True

    def next_candidate(self) -> Dict[str, Any]:
        raise NotImplementedError

    def report_score(self, candidate: Dict[str, Any], score: float) -> None:
        """Hook for adaptive generators (genetic)."""


class RandomSearchGenerator(CandidateGenerator):
    def next_candidate(self):
        return {k: s.value(float(self.rs.rand())) for k, s in self.spaces.items()}


class GridSearchCandidateGenerator(CandidateGenerator):
    """Exhaustive cartesian product with EXACT exhaustion semantics:
    duplicate grid combos are folded away up front (an
    ``IntegerParameterSpace``/``DiscreteParameterSpace`` axis can emit the
    same point twice under a coarse ``discretization_count``), so
    ``has_more()`` counts candidates that will actually be HANDED OUT —
    never a phantom trailing duplicate. ``has_more()``/``next_candidate()``
    share one lock: concurrent callers (a trial fleet filling slots from
    worker threads) each get a distinct combo, and an over-draw raises
    :class:`GeneratorExhausted` instead of ``IndexError``. Exhaustion is
    sticky: once ``has_more()`` is False it stays False."""

    def __init__(self, spaces, discretization_count: int = 3, seed: int = 42):
        super().__init__(spaces, seed)
        import itertools

        axes = [(k, s.grid_points(discretization_count)) for k, s in spaces.items()]
        names = [k for k, _ in axes]
        self._grid, seen = [], set()
        for combo in itertools.product(*[v for _, v in axes]):
            key = repr(combo)
            if key in seen:
                continue
            seen.add(key)
            self._grid.append(dict(zip(names, combo)))
        self._i = 0
        self._lock = threading.Lock()

    def has_more(self):
        with self._lock:
            return self._i < len(self._grid)

    def next_candidate(self):
        with self._lock:
            if self._i >= len(self._grid):
                raise GeneratorExhausted(
                    f"grid of {len(self._grid)} candidates exhausted")
            c = self._grid[self._i]
            self._i += 1
            return c


class GeneticSearchCandidateGenerator(CandidateGenerator):
    """Simple steady-state GA (reference: generator.genetic.*): tournament
    parent selection over scored population, uniform crossover + gaussian
    mutation in u-space."""

    def __init__(self, spaces, population: int = 10, mutation_prob: float = 0.2,
                 mutation_sigma: float = 0.15, seed: int = 42):
        super().__init__(spaces, seed)
        self.population = population
        self.mutation_prob = mutation_prob
        self.mutation_sigma = mutation_sigma
        self._scored: List = []  # (score, cid, u_vector)
        self._pending: Dict[int, np.ndarray] = {}
        self._counter = 0
        # one lock over rs + pending + scored: trials finish on fleet worker
        # threads, so draws and score reports genuinely interleave
        self._lock = threading.Lock()

    def _to_candidate(self, u: np.ndarray) -> Dict[str, Any]:
        cand = {k: s.value(float(u[i])) for i, (k, s) in enumerate(self.spaces.items())}
        cand["__id__"] = self._counter
        self._pending[self._counter] = u
        self._counter += 1
        return cand

    def next_candidate(self):
        n = len(self.spaces)
        with self._lock:
            if len(self._scored) < self.population:
                return self._to_candidate(self.rs.rand(n))
            # tournament select two parents (lower score = better; cid breaks
            # score ties so the pick never depends on arrival order)
            def pick():
                a, b = self.rs.randint(0, len(self._scored), 2)
                sa, sb = self._scored[a], self._scored[b]
                return sa if sa[:2] <= sb[:2] else sb

            (_, _, pa), (_, _, pb) = pick(), pick()
            mask = self.rs.rand(n) < 0.5
            child = np.where(mask, pa, pb)
            mut = self.rs.rand(n) < self.mutation_prob
            child = np.clip(child + mut * self.rs.randn(n) * self.mutation_sigma, 0.0, 1.0 - 1e-9)
            return self._to_candidate(child)

    def report_score(self, candidate, score):
        """Safe under out-of-order and CONCURRENT reports: the scored pool
        is a set ordered by the total key ``(score, cid)`` and truncated to
        its best ``4 * population`` — any permutation of the same reports
        converges to the same pool, so
        subsequent candidates under a fixed seed do not depend on which
        trial happened to finish first. A duplicate or unknown ``__id__``
        is ignored (idempotent): a retried trial reporting twice must not
        double-weight its genome."""
        cid = candidate.get("__id__")
        with self._lock:
            if cid not in self._pending:
                return
            self._scored.append((float(score), cid, self._pending.pop(cid)))
            self._scored.sort(key=lambda t: (t[0], t[1]))
            self._scored = self._scored[: 4 * self.population]


# ---------------------------------------------------------------- termination


class MaxCandidatesCondition:
    def __init__(self, n: int):
        self.n = n

    def terminate(self, evaluated: int, started: float) -> bool:
        return evaluated >= self.n


class MaxTimeCondition:
    def __init__(self, seconds: float):
        self.seconds = seconds

    def terminate(self, evaluated: int, started: float) -> bool:
        return time.monotonic() - started > self.seconds


# --------------------------------------------------------------------- runner


@dataclass
class OptimizationResult:
    best_candidate: Dict[str, Any]
    best_score: float
    best_index: int
    all_results: List = field(default_factory=list)

    def get_best_result(self):
        return self.best_candidate

    getBestResult = get_best_result


class LocalOptimizationRunner:
    """runner.LocalOptimizationRunner: sequential local execution in this
    process (concurrent trials, each a process of its own, are
    :class:`~.fleet.TrialFleet`)."""

    def __init__(self, generator: CandidateGenerator,
                 score_function: Callable[[Dict[str, Any]], float],
                 termination_conditions: Sequence = (),
                 minimize: bool = True):
        self.generator = generator
        self.score_function = score_function
        self.termination_conditions = list(termination_conditions) or [MaxCandidatesCondition(10)]
        self.minimize = minimize

    def execute(self) -> OptimizationResult:
        started = time.monotonic()
        results = []
        best_score = math.inf if self.minimize else -math.inf
        best, best_i = None, -1
        i = 0
        while self.generator.has_more():
            if any(c.terminate(i, started) for c in self.termination_conditions):
                break
            cand = self.generator.next_candidate()
            try:
                score = float(self.score_function({k: v for k, v in cand.items()
                                                   if k != "__id__"}))
            except Exception:
                score = math.inf if self.minimize else -math.inf
            self.generator.report_score(cand, score if self.minimize else -score)
            results.append((dict(cand), score))
            better = score < best_score if self.minimize else score > best_score
            if better:
                best_score, best, best_i = score, dict(cand), i
            i += 1
        best = {k: v for k, v in (best or {}).items() if k != "__id__"}
        return OptimizationResult(best, best_score, best_i, results)
