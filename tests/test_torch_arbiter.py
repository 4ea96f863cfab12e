"""The port's arbiter (``deeplearning4j_tpu_torch.arbiter``: spaces,
generators, runner, ``MultiLayerSpace``) against the JAX package's, on the
CPU, and the JAX package's arbiter behaviour tests run on the port.

Parity is exact: the spaces are pure functions of ``u``, the generators draw
one ``RandomState`` stream in the same order (the genetic one after the same
reported scores), and a materialized ``MultiLayerSpace`` candidate gives the
same configuration JSON as the JAX package's.
"""

import concurrent.futures
import itertools
import json
import math
import random

import numpy as np
import pytest

from deeplearning4j_tpu import arbiter as J
from deeplearning4j_tpu.arbiter.spaces import LayerSpace as JLayerSpace
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu_torch import arbiter as T
from deeplearning4j_tpu_torch.arbiter.spaces import LayerSpace as TLayerSpace
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)
from torch_port_fixtures import one_torch_thread  # noqa: F401  (fixture)


def _spaces(m):
    return {"lr": m.ContinuousParameterSpace(1e-4, 1e-1, log_scale=True),
            "hidden": m.IntegerParameterSpace(4, 32),
            "act": m.DiscreteParameterSpace("relu", "tanh")}


SPACES = _spaces(T)


def _strip(c):
    return {k: v for k, v in c.items() if k != "__id__"}


# ------------------------------------------------------------- JAX parity


SPACE_CASES = {
    "continuous": lambda m: m.ContinuousParameterSpace(-3.0, 5.0),
    "log": lambda m: m.ContinuousParameterSpace(1e-5, 1e-1, log_scale=True),
    "integer": lambda m: m.IntegerParameterSpace(4, 32),
    "integer_small": lambda m: m.IntegerParameterSpace(1, 2),
    "discrete": lambda m: m.DiscreteParameterSpace("relu", "tanh", "elu"),
    "discrete_list": lambda m: m.DiscreteParameterSpace([8, 16, 64]),
}


@pytest.mark.parametrize("kind", sorted(SPACE_CASES))
def test_space_values_and_grid_points_equal_jax(kind):
    from deeplearning4j_tpu.arbiter import optimize as JO
    from deeplearning4j_tpu_torch.arbiter import optimize as TO

    js, ts = SPACE_CASES[kind](JO), SPACE_CASES[kind](TO)
    us = list(np.random.RandomState(0).rand(64)) + [0.0, 0.5, 1.0 - 1e-12]
    assert [ts.value(float(u)) for u in us] == [js.value(float(u)) for u in us]
    for n in (1, 2, 3, 5, 40):
        assert ts.grid_points(n) == js.grid_points(n)
    assert TO.FixedValue(7).grid_points(3) == JO.FixedValue(7).grid_points(3) == [7]


def _stream(mod, cls, seed, n=12, **kw):
    gen = getattr(mod, cls)(_spaces(mod), seed=seed, **kw)
    out = []
    for i in range(n):
        if not gen.has_more():
            break
        c = gen.next_candidate()
        out.append(c)
        gen.report_score(c, float((i * 7) % 5) + 0.25 * (i % 2))
    return out


@pytest.mark.parametrize("cls,kw", [("RandomSearchGenerator", {}),
                                    ("GridSearchCandidateGenerator",
                                     {"discretization_count": 3}),
                                    ("GeneticSearchCandidateGenerator", {"population": 4})])
@pytest.mark.parametrize("seed", [0, 11])
def test_generator_streams_equal_jax(cls, kw, seed):
    """The same seed and the same reported scores give the same candidates,
    ``__id__`` included (the genetic generator's draws after seeding depend
    on its scored pool)."""
    assert _stream(T, cls, seed, **kw) == _stream(J, cls, seed, **kw)


def test_runner_finds_the_same_best_as_jax():
    def make(mod):
        spaces = {"x": mod.ContinuousParameterSpace(-5, 5),
                  "y": mod.ContinuousParameterSpace(-5, 5)}
        return mod.LocalOptimizationRunner(
            mod.GeneticSearchCandidateGenerator(spaces, population=8, seed=3),
            lambda c: (c["x"] - 1.0) ** 2 + (c["y"] + 2.0) ** 2,
            [mod.MaxCandidatesCondition(60)]).execute()

    t, j = make(T), make(J)
    assert (t.best_candidate, t.best_score, t.best_index) == \
        (j.best_candidate, j.best_score, j.best_index)
    assert t.all_results == j.all_results


def _mls(mod, conf, layer_space):
    return (mod.MultiLayerSpace.Builder().seed(7)
            .learning_rate(mod.ContinuousParameterSpace(1e-3, 1e-1, log_scale=True))
            .add_layer(layer_space(conf.DenseLayer, n_in=6,
                                   n_out=mod.IntegerParameterSpace(4, 24),
                                   activation=mod.DiscreteParameterSpace("tanh", "relu")))
            .add_layer(layer_space(conf.OutputLayer, n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(conf.InputType.feed_forward(6))
            .build())


def test_multilayer_space_materializes_jax_conf_json():
    tm, jm = _mls(T, TC, TLayerSpace), _mls(J, JC, JLayerSpace)
    assert sorted(tm.param_spaces()) == sorted(jm.param_spaces()) == [
        "layer0.activation", "layer0.n_out", "learning_rate"]
    tgen = T.RandomSearchGenerator(tm.param_spaces(), seed=2)
    jgen = J.RandomSearchGenerator(jm.param_spaces(), seed=2)
    for _ in range(4):
        tc, jc = tgen.next_candidate(), jgen.next_candidate()
        assert tc == jc
        tj, jj = json.loads(tm.materialize(tc).to_json()), json.loads(jm.materialize(jc).to_json())
        assert tj == jj


# ------------------------------------------ the JAX package's behaviour tests


def test_parameter_spaces():
    c = T.ContinuousParameterSpace(0.001, 0.1, log_scale=True)
    assert 0.001 <= c.value(0.0) < c.value(0.999) <= 0.1
    i = T.IntegerParameterSpace(4, 8)
    assert set(i.grid_points(10)) == {4, 5, 6, 7, 8}
    d = T.DiscreteParameterSpace("relu", "tanh")
    assert d.value(0.0) == "relu" and d.value(0.99) == "tanh"


def test_grid_generator_enumerates_product():
    gen = T.GridSearchCandidateGenerator(
        {"a": T.DiscreteParameterSpace(1, 2), "b": T.DiscreteParameterSpace("x", "y", "z")})
    cands = []
    while gen.has_more():
        cands.append(tuple(gen.next_candidate().values()))
    assert len(cands) == 6 and len(set(cands)) == 6


def test_runner_finds_quadratic_minimum():
    spaces = {"x": T.ContinuousParameterSpace(-5, 5), "y": T.ContinuousParameterSpace(-5, 5)}
    res = T.LocalOptimizationRunner(
        T.RandomSearchGenerator(spaces, seed=3),
        lambda c: (c["x"] - 1.0) ** 2 + (c["y"] + 2.0) ** 2,
        [T.MaxCandidatesCondition(200)]).execute()
    assert res.best_score < 0.5
    assert abs(res.best_candidate["x"] - 1.0) < 1.0
    assert abs(res.best_candidate["y"] + 2.0) < 1.0
    assert res.get_best_result() == res.best_candidate


def test_genetic_beats_random_on_budget():
    spaces = {f"x{i}": T.ContinuousParameterSpace(-3, 3) for i in range(4)}

    def score(c):
        return sum((v - 1.0) ** 2 for v in c.values())

    res_g = T.LocalOptimizationRunner(
        T.GeneticSearchCandidateGenerator(spaces, population=12, seed=5),
        score, [T.MaxCandidatesCondition(120)]).execute()
    res_r = T.LocalOptimizationRunner(
        T.RandomSearchGenerator(spaces, seed=5), score,
        [T.MaxCandidatesCondition(120)]).execute()
    assert res_g.best_score <= res_r.best_score * 1.5
    assert res_g.best_score < 1.0


def test_runner_scores_a_failing_candidate_as_worst_and_honours_max_time():
    spaces = {"x": T.ContinuousParameterSpace(0, 1)}

    def boom(c):
        if c["x"] < 0.5:
            raise RuntimeError("candidate failed")
        return c["x"]

    res = T.LocalOptimizationRunner(T.RandomSearchGenerator(spaces, seed=1), boom,
                                    [T.MaxCandidatesCondition(20)]).execute()
    assert all(s == math.inf for c, s in res.all_results if c["x"] < 0.5)
    assert 0.5 <= res.best_candidate["x"] == res.best_score
    timed = T.LocalOptimizationRunner(T.RandomSearchGenerator(spaces, seed=1), boom,
                                      [T.MaxTimeCondition(-1.0)]).execute()
    assert timed.all_results == [] and timed.best_index == -1


def test_multilayer_space_search(one_torch_thread):  # noqa: F811
    """End-to-end: search layer width + lr on a tiny classification task
    with port networks on the CPU."""
    rs = np.random.RandomState(0)
    X = rs.randn(96, 6).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[np.argmax(X[:, :3], 1)]
    mls = (T.MultiLayerSpace.Builder().seed(7)
           .learning_rate(T.ContinuousParameterSpace(1e-3, 1e-1, log_scale=True))
           .add_layer(TLayerSpace(TC.DenseLayer, n_in=6, n_out=T.IntegerParameterSpace(4, 24),
                                  activation="tanh"))
           .add_layer(TLayerSpace(TC.OutputLayer, n_out=3, activation="softmax", loss="mcxent"))
           .build())
    spaces = mls.param_spaces()
    assert set(spaces) == {"learning_rate", "layer0.n_out"}

    def score(candidate):
        net = MultiLayerNetwork(mls.materialize(candidate), device="cpu").init()
        for _ in range(8):
            net._fit_batch(DataSet(X, Y))
        return net.score_

    res = T.LocalOptimizationRunner(T.RandomSearchGenerator(spaces, seed=1), score,
                                    [T.MaxCandidatesCondition(5)]).execute()
    assert np.isfinite(res.best_score)
    assert 4 <= res.best_candidate["layer0.n_out"] <= 24
    assert len(res.all_results) == 5


def test_grid_exhaustion_is_exact_and_sticky():
    gen = T.GridSearchCandidateGenerator(
        {"a": T.DiscreteParameterSpace(1, 2), "b": T.DiscreteParameterSpace("x", "y", "z")})
    seen = []
    for _ in range(6):
        assert gen.has_more()
        seen.append(tuple(gen.next_candidate().values()))
    assert len(set(seen)) == 6
    assert not gen.has_more()
    with pytest.raises(T.GeneratorExhausted):
        gen.next_candidate()
    assert not gen.has_more()


def test_grid_folds_duplicate_combos_before_counting():
    gen = T.GridSearchCandidateGenerator(
        {"n": T.IntegerParameterSpace(1, 2), "b": T.DiscreteParameterSpace("x", "y")},
        discretization_count=5)
    out = []
    while gen.has_more():
        out.append(tuple(sorted(gen.next_candidate().items())))
    assert len(out) == 4
    assert len(set(out)) == len(out)


def test_grid_concurrent_draws_hand_out_distinct_candidates():
    gen = T.GridSearchCandidateGenerator(
        {"a": T.DiscreteParameterSpace(*range(8)), "b": T.DiscreteParameterSpace(*range(8))})

    def draw_all():
        got = []
        while True:
            try:
                got.append(tuple(sorted(gen.next_candidate().items())))
            except T.GeneratorExhausted:
                return got

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        chunks = list(ex.map(lambda _: draw_all(), range(8)))
    flat = list(itertools.chain.from_iterable(chunks))
    assert len(flat) == 64
    assert len(set(flat)) == 64


def test_generators_are_seed_deterministic():
    for cls, kwargs in ((T.RandomSearchGenerator, {}),
                        (T.GridSearchCandidateGenerator, {"discretization_count": 3}),
                        (T.GeneticSearchCandidateGenerator, {"population": 4})):
        a, b = cls(SPACES, seed=11, **kwargs), cls(SPACES, seed=11, **kwargs)
        other = cls(SPACES, seed=12, **kwargs)
        sa, sb, so = [], [], []
        for i in range(8):
            ca, cb, co = (g.next_candidate() for g in (a, b, other))
            sa.append(_strip(ca)), sb.append(_strip(cb)), so.append(_strip(co))
            for g, c in ((a, ca), (b, cb), (other, co)):
                g.report_score(c, float(i % 3))
        assert sa == sb
        if cls is not T.GridSearchCandidateGenerator:
            assert sa != so


def test_log_scale_continuous_respects_bounds():
    s = T.ContinuousParameterSpace(1e-4, 1e-1, log_scale=True)
    lo, hi = s.value(0.0), s.value(1.0 - 1e-12)
    assert lo == pytest.approx(1e-4)
    assert hi <= 1e-1 and hi == pytest.approx(1e-1, rel=1e-6)
    assert s.value(0.5) == pytest.approx(math.sqrt(1e-4 * 1e-1), rel=1e-6)
    rs = np.random.RandomState(0)
    for u in rs.rand(200):
        assert 1e-4 <= s.value(float(u)) <= 1e-1
    for u in rs.rand(64):
        assert 4 <= T.IntegerParameterSpace(4, 32).value(float(u)) <= 32


def test_genetic_mutation_stays_inside_space_bounds():
    gen = T.GeneticSearchCandidateGenerator(SPACES, population=4, mutation_prob=1.0,
                                            mutation_sigma=5.0, seed=2)
    for i in range(4):
        gen.report_score(gen.next_candidate(), float(i))
    for _ in range(64):
        c = _strip(gen.next_candidate())
        assert 1e-4 <= c["lr"] <= 1e-1
        assert 4 <= c["hidden"] <= 32
        assert c["act"] in ("relu", "tanh")


def _drain_deterministic_tail(gen):
    return [_strip(gen.next_candidate()) for _ in range(12)]


def test_genetic_report_order_does_not_change_stream():
    def seeded(order_seed):
        gen = T.GeneticSearchCandidateGenerator(SPACES, population=6, seed=9)
        cands = [gen.next_candidate() for _ in range(6)]
        reports = [(c, float(i % 4)) for i, c in enumerate(cands)]
        random.Random(order_seed).shuffle(reports)
        for c, s in reports:
            gen.report_score(c, s)
        return _drain_deterministic_tail(gen)

    ref = seeded(0)
    for order_seed in (1, 2, 3):
        assert seeded(order_seed) == ref


def test_genetic_report_is_concurrent_safe_and_idempotent():
    gen = T.GeneticSearchCandidateGenerator(SPACES, population=8, seed=9)
    cands = [gen.next_candidate() for _ in range(8)]
    reports = [(c, float(i % 4)) for i, c in enumerate(cands)]
    reports += reports[:3]
    reports.append(({"__id__": 10_000, "lr": 1e-3}, 0.0))
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda r: gen.report_score(*r), reports))
    assert len(gen._scored) == 8
    ref = T.GeneticSearchCandidateGenerator(SPACES, population=8, seed=9)
    for i, c in enumerate([ref.next_candidate() for _ in range(8)]):
        ref.report_score(c, float(i % 4))
    assert _drain_deterministic_tail(gen) == _drain_deterministic_tail(ref)
