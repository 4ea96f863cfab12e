"""The port's datavec transforms and audio reader against the JAX package's.

``data/transform.py`` and ``data/audio.py`` are host Python over rows and
files; the bar is equality: the same rows (or WAV files) in give the same
rows (features, labels) out, and ``to_json`` writes the same text, so a
process saved by either package loads in the other. Rows come from a seeded
numpy draw. Tolerances: none for rows, JSON and waveforms (bit for bit); the
spectrogram within 1e-6 absolute of the JAX package's and of a float64 STFT
written out here.
"""

import json
import math
import wave

import numpy as np
import pytest

from deeplearning4j_tpu.data import audio as JA
from deeplearning4j_tpu.data import transform as JT
from deeplearning4j_tpu.data.image import ParentPathLabelGenerator as JLabels
from deeplearning4j_tpu.data.records import FileSplit as JFileSplit
from deeplearning4j_tpu_torch.data import audio as TA
from deeplearning4j_tpu_torch.data import transform as TT
from deeplearning4j_tpu_torch.data.image import ParentPathLabelGenerator as TLabels
from deeplearning4j_tpu_torch.data.records import FileSplit as TFileSplit
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

SPECTROGRAM_ATOL = 1e-6


def _canon(rows):
    """Rows with NaN made comparable (NaN != NaN under ``==``)."""
    def c(v):
        if isinstance(v, float) and math.isnan(v):
            return "<nan>"
        if isinstance(v, list):
            return [c(x) for x in v]
        return v
    return c(rows)


def _schema(M):
    return (M.Schema.Builder()
            .add_column_string("DateTimeString")
            .add_column_string("CustomerID")
            .add_column_categorical("MerchantCountryCode", "USA", "CAN", "FR", "MX")
            .add_column_double("TransactionAmountUSD")
            .add_column_integer("NumItems")
            .add_column_string("Note")
            .add_column_categorical("FraudLabel", "Fraud", "Legit")
            .build())


def _rows(seed=0, n=200):
    rs = np.random.RandomState(seed)
    countries = ["USA", "CAN", "FR", "MX"]
    rows = []
    for i in range(n):
        t = 1_450_000_000 + int(rs.randint(0, 40_000_000))
        stamp = "%04d-%02d-%02d %02d:%02d:%02d" % (
            2016, 1 + t % 12, 1 + t % 28, t % 24, (t // 7) % 60, (t // 11) % 60)
        amount = float(np.round(rs.exponential(80.0), 2))
        rows.append([stamp, f"C{rs.randint(0, 30):03d}", countries[rs.randint(0, 4)],
                     amount if i % 37 else float("nan"), int(rs.randint(1, 9)),
                     [" Gift ", "BULK", "none ", ""][rs.randint(0, 4)],
                     "Fraud" if rs.rand() < 0.1 else "Legit"])
    return rows


def _processes(M):
    """One process per step kind (and one chaining many), built through
    the module ``M``'s builder: the same calls for both packages."""
    s = _schema(M)
    B = lambda: M.TransformProcess.Builder(s)  # noqa: E731
    red = (M.Reducer.Builder("CustomerID").sum_columns("TransactionAmountUSD")
           .mean_columns("NumItems").count_columns("Note").build())
    red2 = (M.Reducer.Builder("MerchantCountryCode").stdev_columns("TransactionAmountUSD")
            .range_columns("NumItems").min_columns("NumItems").max_columns("NumItems")
            .count_unique_columns("CustomerID").take_first_columns("Note")
            .take_last_columns("DateTimeString").build())
    return {
        "remove_columns": B().remove_columns("Note", "CustomerID").build(),
        "rename_column": B().rename_column("NumItems", "Items").build(),
        "categorical_to_integer": B().categorical_to_integer("MerchantCountryCode").build(),
        "categorical_to_one_hot": B().categorical_to_one_hot("MerchantCountryCode").build(),
        "double_math_op": B().double_math_op("TransactionAmountUSD", "Multiply", 1.5)
                             .double_math_op("NumItems", "Pow", 2).build(),
        "string_map": B().string_map_transform("Note", "strip")
                         .string_map_transform("CustomerID", "lower").build(),
        "filter_invalid": B().filter_invalid("TransactionAmountUSD").build(),
        "convert_to_double": B().convert_to_double("NumItems").build(),
        "string_to_time": B().string_to_time("DateTimeString").build(),
        "derive_time_fields": B().string_to_time("DateTimeString")
                                 .derive_time_fields("DateTimeString", "hourOfDay",
                                                     "dayOfWeek", "monthOfYear").build(),
        "conditional_replace": B().conditional_replace("NumItems", "gt", 5, 5).build(),
        "filter_by_condition": B().filter_by_condition("MerchantCountryCode", "eq", "FR")
                                  .build(),
        "reduce": B().filter_invalid("TransactionAmountUSD").reduce(red).build(),
        "reduce_more": B().filter_invalid("TransactionAmountUSD").reduce(red2).build(),
        "columns_math_op": B().columns_math_op("per_item", "divide", "TransactionAmountUSD",
                                               "NumItems")
                              .columns_math_op("mod", "modulus", "NumItems", "NumItems")
                              .build(),
        "conditional_copy": B().conditional_copy("Note", "CustomerID", "FraudLabel", "eq",
                                                 "Fraud").build(),
        "chained": (B().remove_columns("CustomerID", "Note")
                    .categorical_to_one_hot("MerchantCountryCode")
                    .string_to_time("DateTimeString")
                    .derive_time_fields("DateTimeString")
                    .filter_invalid("TransactionAmountUSD")
                    .filter_by_condition("TransactionAmountUSD", "lt", 10.0)
                    .categorical_to_integer("FraudLabel").build()),
    }


KINDS = sorted(_processes(TT))


@pytest.mark.parametrize("kind", KINDS)
def test_every_step_kind_gives_the_jax_rows_and_json(kind):
    jp, tp = _processes(JT)[kind], _processes(TT)[kind]
    rows = _rows(seed=KINDS.index(kind))
    assert _canon(tp.execute([list(r) for r in rows])) == \
        _canon(jp.execute([list(r) for r in rows]))
    assert tp.final_schema().to_json() == jp.final_schema().to_json()
    assert tp.to_json() == jp.to_json()
    # a process saved by either package loads in the other
    for src, dst in ((tp, JT), (jp, TT)):
        back = dst.TransformProcess.from_json(src.to_json())
        assert back.to_json() == jp.to_json()
        assert _canon(back.execute([list(r) for r in rows])) == \
            _canon(jp.execute([list(r) for r in rows]))


def test_camelcase_aliases_are_the_jax_builders():
    for name in ("removeColumns", "renameColumn", "categoricalToInteger",
                 "categoricalToOneHot", "doubleMathOp", "convertToDouble",
                 "stringToTimeTransform", "conditionalReplaceValueTransform",
                 "doubleColumnsMathOp", "conditionalCopyValueTransform"):
        assert hasattr(TT.TransformProcess.Builder, name) == \
            hasattr(JT.TransformProcess.Builder, name) is True
    for name in ("addColumnString", "addColumnInteger", "addColumnDouble",
                 "addColumnCategorical"):
        assert hasattr(TT.Schema.Builder, name)
    s = (TT.Schema.Builder().addColumnString("a").addColumnDouble("b").build())
    tp = TT.TransformProcess.Builder(s).doubleMathOp("b", "Add", 1.0).renameColumn(
        "a", "c").build()
    assert tp.getFinalSchema().names() == ["c", "b"]
    assert tp.execute([["x", 1.0]]) == [["x", 2.0]]


@pytest.mark.parametrize("join_type", ["Inner", "LeftOuter"])
def test_join_equals_jax(join_type):
    rows = _rows(seed=3, n=60)
    def side(M):
        left = _schema(M)
        right = (M.Schema.Builder().add_column_string("CustomerID")
                 .add_column_double("CreditLimit").add_column_integer("Tier").build())
        return left, right
    rs = np.random.RandomState(4)
    right_rows = [[f"C{i:03d}", float(rs.randint(100, 5000)), int(rs.randint(1, 4))]
                  for i in range(0, 30, 2)] + [["C004", 1.0, 9]]
    got = TT.join(*side(TT)[:1], rows, side(TT)[1], right_rows, "CustomerID", join_type)
    want = JT.join(*side(JT)[:1], rows, side(JT)[1], right_rows, "CustomerID", join_type)
    assert got[0].to_json() == want[0].to_json()
    assert _canon(got[1]) == _canon(want[1])
    with pytest.raises(ValueError):
        TT.join(side(TT)[0], rows, side(TT)[1], right_rows, "CustomerID", "Outer")


def test_data_and_quality_analyses_equal_jax():
    rows = _rows(seed=5)
    rows[3][4] = "seven"  # an integer column that does not parse
    rows[4][2] = "DE"  # a state the categorical column does not list
    rows[5][5] = None
    for M_t, M_j in ((TT.DataAnalysis, JT.DataAnalysis),
                     (TT.DataQualityAnalysis, JT.DataQualityAnalysis)):
        got = M_t.analyze(_schema(TT), [list(r) for r in rows])
        want = M_j.analyze(_schema(JT), [list(r) for r in rows])
        assert got.to_json() == want.to_json()


def test_sequence_helpers_equal_jax():
    rows = _rows(seed=6, n=120)
    out = {}
    for M in (TT, JT):
        s = M.TransformProcess.Builder(_schema(M)).string_to_time("DateTimeString").build()
        schema = s.final_schema()
        seqs = M.convert_to_sequence(schema, s.execute([list(r) for r in rows]),
                                     "CustomerID", sort_column="DateTimeString")
        split = M.split_sequences(seqs, M.SplitMaxLengthSequence(3))
        shifted = M.offset_sequence(schema, seqs, ["TransactionAmountUSD", "NumItems"], 1)
        appended = M.offset_sequence(schema, seqs, ["NumItems"], -2, mode="new_column")
        red = (M.Reducer.Builder("CustomerID").sum_columns("NumItems")
               .take_last_columns("DateTimeString").build())
        windows = M.reduce_sequence_by_window(schema, seqs, 2, red)
        out[M] = [seqs, split, shifted, appended, windows]
    for got, want in zip(out[TT], out[JT]):
        assert _canon(got) == _canon(want)
    with pytest.raises(ValueError, match="mode"):
        TT.offset_sequence(_schema(TT), [], ["NumItems"], 1, mode="sideways")


# ------------------------------------------------------------------- audio


def _write_wav(path, samples, width, channels=1, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())


def _pcm(rs, n, width, channels=1):
    if width == 1:
        return rs.randint(0, 256, n * channels).astype(np.uint8)
    if width == 2:
        return rs.randint(-32768, 32768, n * channels).astype("<i2")
    return rs.randint(-2**31, 2**31, n * channels, dtype=np.int64).astype("<i4")


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_read_wav_equals_jax(tmp_path, width, channels):
    rs = np.random.RandomState(10 * width + channels)
    path = tmp_path / f"w{width}c{channels}.wav"
    _write_wav(path, _pcm(rs, 4001, width, channels), width, channels, rate=8000 * width)
    got, rate = TA.read_wav(str(path))
    want, want_rate = JA.read_wav(str(path))
    assert rate == want_rate == 8000 * width
    assert got.dtype == want.dtype == np.float32 and got.shape == (4001,)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 1.0


def test_spectrogram_equals_jax_and_a_float64_stft():
    rs = np.random.RandomState(7)
    for n, n_fft, hop in ((16000, 256, 128), (100, 256, 128), (5000, 128, 32)):
        x = rs.uniform(-1, 1, n).astype(np.float32)
        got = TA.spectrogram(x, n_fft, hop)
        np.testing.assert_allclose(got, JA.spectrogram(x, n_fft, hop), rtol=0,
                                   atol=SPECTROGRAM_ATOL)
        xp = np.pad(x, (0, max(0, n_fft - n))).astype(np.float64)
        win = np.hanning(n_fft)
        ref = np.stack([np.abs(np.fft.rfft(xp[s:s + n_fft] * win))
                        for s in range(0, len(xp) - n_fft + 1, hop)])
        assert got.shape == ref.shape == ((len(xp) - n_fft) // hop + 1, n_fft // 2 + 1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=SPECTROGRAM_ATOL * max(1.0, n_fft / 64))


@pytest.mark.parametrize("features", ["waveform", "spectrogram"])
def test_wav_reader_equals_jax(tmp_path, features):
    rs = np.random.RandomState(11)
    for c in ("dog", "cat", "bird"):
        (tmp_path / c).mkdir()
        for i in range(3):
            _write_wav(tmp_path / c / f"{i}.wav", _pcm(rs, 1000 + 300 * i, 2), 2)
    (tmp_path / "dog" / "notes.txt").write_text("not audio")
    got = TA.WavFileRecordReader(features=features, max_samples=1200, label_generator=TLabels())
    want = JA.WavFileRecordReader(features=features, max_samples=1200,
                                  label_generator=JLabels())
    got.initialize(TFileSplit(str(tmp_path)))
    want.initialize(JFileSplit(str(tmp_path)))
    assert got.labels() == want.labels() == ["bird", "cat", "dog"]
    n = 0
    while want.has_next():
        assert got.has_next()
        (gf, gl), (wf, wl) = got.next(), want.next()
        assert gl == wl
        np.testing.assert_array_equal(gf, wf)
        assert gf.shape == ((1200,) if features == "waveform" else (8, 129))
        n += 1
    assert n == 9 and not got.has_next()
    with pytest.raises(ValueError, match="waveform"):
        TA.WavFileRecordReader(features="mfcc")


def test_data_package_exports_the_transforms_lazily():
    import subprocess
    import sys

    script = ("import sys\n"
              "from deeplearning4j_tpu_torch.data import TransformProcess, Schema, Reducer\n"
              "from deeplearning4j_tpu_torch.data.audio import WavFileRecordReader\n"
              "assert 'torch' not in sys.modules\n"
              "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=60, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.stdout.strip() == "ok", out.stderr
    from deeplearning4j_tpu.data import __all__ as jax_all
    import deeplearning4j_tpu_torch.data as D

    for name in ("DataQualityAnalysis", "Reducer", "Schema", "SplitMaxLengthSequence",
                 "TransformProcess", "convert_to_sequence", "offset_sequence",
                 "reduce_sequence_by_window", "split_sequences"):
        assert getattr(D, name) is getattr(TT, name)
    assert {"Schema", "TransformProcess"} <= set(jax_all) & set(D.__all__)
    assert json.loads(TT.Schema.Builder().add_column_integer("a").build().to_json()) == \
        {"columns": [{"name": "a", "type": "Integer"}]}
