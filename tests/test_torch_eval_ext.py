"""The port's ``EvaluationBinary``, ``ROC``, ``ROCMultiClass`` and
``EvaluationCalibration``, and its Iris, CIFAR-10, EMNIST and TinyImageNet
iterators, against the JAX package's, on the CPU.

The evaluations are host numpy in both packages: on the same seeded labels,
predictions and masks, eval'd in minibatches and merged, every count and
every derived number (AUC, ECE, the reliability diagram) is equal exactly;
torch tensors give what their numpy copies give. The iterators' batches and
``state``/``set_state`` positions are the JAX package's bit for bit.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import datasets as JD
from deeplearning4j_tpu.eval import evaluation as JE
from deeplearning4j_tpu_torch.data import datasets as TD
from deeplearning4j_tpu_torch.eval import evaluation as TE
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _multiclass(rs, n, c):
    y = np.eye(c, dtype=np.float32)[rs.randint(0, c, n)]
    # informative but imperfect probabilities
    p = _softmax(2.0 * y + rs.randn(n, c)).astype(np.float32)
    return y, p


def _binary(rs, n, k):
    y = (rs.rand(n, k) < 0.4).astype(np.float32)
    p = np.clip(0.5 * y + 0.5 * rs.rand(n, k), 0, 1).astype(np.float32)
    return y, p


def _eval_and_merge(mod, cls, batches, **kw):
    """Each batch into its own accumulator, merged into the first."""
    evs = []
    for y, p, m in batches:
        ev = getattr(mod, cls)(**kw)
        ev.eval(y, p, mask=m)
        evs.append(ev)
    for ev in evs[1:]:
        evs[0].merge(ev)
    return evs[0]


def _as_torch(batches):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))  # noqa: E731
    return [(t(y), t(p), t(m)) for y, p, m in batches]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_evaluation_binary_equals_jax(masked, threshold):
    rs = np.random.RandomState(1)
    batches = []
    for n in (16, 9, 23):
        y, p = _binary(rs, n, 5)
        batches.append((y, p, (rs.rand(n, 5) < 0.8).astype(np.float32) if masked else None))
    j = _eval_and_merge(JE, "EvaluationBinary", batches, threshold=threshold)
    for src in (batches, _as_torch(batches)):
        t = _eval_and_merge(TE, "EvaluationBinary", src, threshold=threshold)
        for name in ("tp", "fp", "tn", "fn"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        for metric in ("accuracy", "precision", "recall"):
            np.testing.assert_array_equal(getattr(t, metric)(), getattr(j, metric)())
    # an empty accumulator takes the merged counts
    np.testing.assert_array_equal(TE.EvaluationBinary(threshold).merge(t).tp, j.tp)


@pytest.mark.parametrize("steps", [200, 17])
@pytest.mark.parametrize("masked", [False, True])
def test_roc_equals_jax(steps, masked):
    rs = np.random.RandomState(2)
    batches = []
    for n in (40, 13):
        y, p = _binary(rs, n, 1)
        batches.append((y[:, 0], p[:, 0], (rs.rand(n) < 0.7) if masked else None))
    j = _eval_and_merge(JE, "ROC", batches, threshold_steps=steps)
    for src in (batches, _as_torch(batches)):
        t = _eval_and_merge(TE, "ROC", src, threshold_steps=steps)
        assert t.calculate_auc() == t.calculateAUC() == j.calculate_auc()
    assert 0.5 < j.calculate_auc() <= 1.0
    one_class = TE.ROC()
    one_class.eval(np.ones(4), np.full(4, 0.7))
    assert one_class.calculate_auc() == 0.0


@pytest.mark.parametrize("layout", ["2d", "3d_masked"])
def test_roc_multiclass_equals_jax(layout):
    rs = np.random.RandomState(3)
    batches = []
    for n in (24, 11):
        if layout == "2d":
            y, p = _multiclass(rs, n, 4)
            batches.append((y, p, None))
        else:  # DL4J time series [N, C, T] with a [N, T] mask
            y, p = _multiclass(rs, n * 5, 4)
            to3 = lambda a: a.reshape(n, 5, 4).transpose(0, 2, 1)  # noqa: E731
            batches.append((to3(y), to3(p), (rs.rand(n, 5) < 0.75).astype(np.float32)))
    j = _eval_and_merge(JE, "ROCMultiClass", batches)
    for src in (batches, _as_torch(batches)):
        t = _eval_and_merge(TE, "ROCMultiClass", src)
        assert t.num_classes() == j.num_classes() == 4
        assert [t.calculate_auc(c) for c in range(4)] == [j.calculate_auc(c) for c in range(4)]
        assert t.calculate_average_auc() == t.calculateAverageAUC() == j.calculate_average_auc()
    # merging into a fresh accumulator copies, never aliases
    fresh = TE.ROCMultiClass().merge(t)
    fresh.eval(*batches[0][:2], mask=batches[0][2])
    assert t.calculate_average_auc() == j.calculate_average_auc()
    assert TE.ROCMultiClass().calculate_average_auc() == 0.0


@pytest.mark.parametrize("bins", [10, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_evaluation_calibration_equals_jax(bins, masked):
    rs = np.random.RandomState(4)
    batches = []
    for n in (30, 17, 5):
        y, p = _multiclass(rs, n, 6)
        batches.append((y, p, (rs.rand(n) < 0.8).astype(np.float32) if masked else None))
    j = _eval_and_merge(JE, "EvaluationCalibration", batches, reliability_bins=bins)
    for src in (batches, _as_torch(batches)):
        t = _eval_and_merge(TE, "EvaluationCalibration", src, reliability_bins=bins)
        assert t.expected_calibration_error() == j.expected_calibration_error()
        assert repr(t.reliability_diagram()) == repr(j.reliability_diagram())
        assert repr(t.getReliabilityInfo()) == repr(t.reliability_diagram())
        for a in ("_counts", "_correct", "_conf_sum"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
    with pytest.raises(ValueError, match="reliability_bins"):
        TE.EvaluationCalibration(bins).merge(TE.EvaluationCalibration(bins + 1))
    assert TE.EvaluationCalibration().expected_calibration_error() == 0.0


def test_multiclass_evaluations_of_a_time_series_equal_jax():
    """The same [N, C, T] outputs through ``Evaluation`` (the port's existing
    class) and the calibration, masked, as the JAX package flattens them."""
    rs = np.random.RandomState(5)
    y, p = _multiclass(rs, 8 * 6, 3)
    to3 = lambda a: a.reshape(8, 6, 3).transpose(0, 2, 1)  # noqa: E731
    m = (rs.rand(8, 6) < 0.7).astype(np.float32)
    for cls in ("Evaluation", "EvaluationCalibration"):
        j, t = getattr(JE, cls)(), getattr(TE, cls)()
        j.eval(to3(y), to3(p), mask=m)
        t.eval(torch.from_numpy(to3(y)), torch.from_numpy(to3(p)), mask=torch.from_numpy(m))
        if cls == "Evaluation":
            np.testing.assert_array_equal(t.confusion, j.confusion)
        else:
            assert t.expected_calibration_error() == j.expected_calibration_error()


# ---------------------------------------------------------------- iterators


def _batches(it):
    out = []
    while it.has_next():
        ds = it.next()
        out.append((ds.features, ds.labels))
    return out


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for (fa, la), (fb, lb) in zip(a, b):
        assert fa.dtype == fb.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("kw", [{}, {"batch_size": 32, "num_examples": 100},
                                {"batch_size": 50, "shuffle_seed": None}])
def test_iris_iterator_equals_jax(kw):
    X, Y = TD._iris_arrays()
    JX, JY = JD._iris_arrays()
    np.testing.assert_array_equal(X, JX)
    np.testing.assert_array_equal(Y, JY)
    assert X.shape == (150, 4) and Y.sum(0).tolist() == [50, 50, 50]
    _assert_same_batches(_batches(TD.IrisDataSetIterator(**kw)),
                         _batches(JD.IrisDataSetIterator(**kw)))
    it = TD.IrisDataSetIterator(**kw)
    assert [ds.features.shape[0] for ds in it] == [ds.features.shape[0]
                                                   for ds in JD.IrisDataSetIterator(**kw)]


ITERATORS = {
    "cifar10": ("Cifar10DataSetIterator", dict(batch_size=16, num_examples=40)),
    "cifar10_test": ("Cifar10DataSetIterator", dict(batch_size=16, train=False,
                                                    num_examples=20, seed=5)),
    "emnist_letters": ("EmnistDataSetIterator", dict(batch_size=32, num_examples=70)),
    "emnist_balanced": ("EmnistDataSetIterator", dict(batch_size=32, num_examples=40,
                                                      dataset="balanced")),
    "tinyimagenet": ("TinyImageNetDataSetIterator", dict(batch_size=8, num_examples=12)),
}


@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_synthetic_image_iterators_equal_jax_with_state(name):
    cls, kw = ITERATORS[name]
    t, j = getattr(TD, cls)(**kw), getattr(JD, cls)(**kw)
    assert t.synthetic and t.classes == j.classes and t.batch() == kw["batch_size"]
    first = t.next()
    j.next()
    st = t.state()
    assert st == j.state() == {"pos": kw["batch_size"]}
    rest_t, rest_j = _batches(t), _batches(j)
    _assert_same_batches(rest_t, rest_j)
    # back to the saved position: the same tail again, in a fresh iterator too
    t.set_state(st)
    _assert_same_batches(_batches(t), rest_t)
    again = getattr(TD, cls)(**kw)
    again.set_state(st)
    _assert_same_batches(_batches(again), rest_t)
    t.reset()
    np.testing.assert_array_equal(t.next().features, first.features)
    assert first.features.shape[1:] == {"Cifar10DataSetIterator": (3, 32, 32),
                                        "EmnistDataSetIterator": (1, 28, 28),
                                        "TinyImageNetDataSetIterator": (3, 64, 64)}[cls]
    assert 0.0 <= float(first.features.min()) and float(first.features.max()) <= 1.0


def test_emnist_rejects_an_unknown_split():
    with pytest.raises(ValueError, match="unknown EMNIST split"):
        TD.EmnistDataSetIterator(8, dataset="klingon")
