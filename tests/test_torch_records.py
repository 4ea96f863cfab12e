"""Port parity: the record readers, splits and ``load_csv_f32``
(``deeplearning4j_tpu_torch.data.records``) and
``RecordReaderDataSetIterator``, against the JAX package's, on the CPU.

Every reader, over the same files, gives the records the JAX package's
gives, in the same order; ``load_csv_f32`` gives JAX's array (whichever path
JAX takes here: its native parser when built, numpy otherwise) and None for
a non-numeric file; ``RecordReaderDataSetIterator`` gives equal DataSets.
"""

import json

import numpy as np
import pytest

import test_data as _jax_data_tests  # the JAX tests' .xlsx writer
from deeplearning4j_tpu.data import record_reader_iterator as JRI
from deeplearning4j_tpu.data import records as JR
from deeplearning4j_tpu_torch.data import record_reader_iterator as TRI
from deeplearning4j_tpu_torch.data import records as TR
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


@pytest.fixture
def files(tmp_path):
    rs = np.random.RandomState(0)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    rows = [",".join(f"{v:.4f}" for v in rs.rand(4)) + f",{rs.randint(0, 3)}" for _ in range(9)]
    (tmp_path / "a" / "x.csv").write_text("h1,h2,h3,h4,label\n" + "\n".join(rows[:5]) + "\n")
    (tmp_path / "b" / "y.csv").write_text("h1,h2,h3,h4,label\n" + "\n".join(rows[5:]) + "\n")
    (tmp_path / "a" / "q.csv").write_text('1,"two, quoted",3\n4;5,6\n')
    (tmp_path / "svm.txt").write_text("1 1:0.5 3:2.0 # c\n0 qid:3 2:1.5\n-1 4:7\n")
    (tmp_path / "re.txt").write_text("skip me\nid=7 name=ab\nid=8 name=cd\n")
    (tmp_path / "j.jsonl").write_text("\n".join(json.dumps(o) for o in (
        {"a": 1, "b": "x"}, {"b": "y", "c": 2}, {"a": 3.5})) + "\n")
    (tmp_path / "text.txt").write_text("first line\n\nthird, with comma\n")
    _jax_data_tests.TestExcelRecordReader._write_xlsx(
        str(tmp_path / "book.xlsx"), [["name", "x", "y"], ["a", 1.5, 2.0], ["b", None, 3.0]],
        shared=["name", "x", "y", "a", "b"])
    return tmp_path


def test_file_split_lists_the_same_files(files):
    for kw in ({}, {"allowed_extensions": [".csv"]}, {"recursive": False}):
        assert TR.FileSplit(str(files), **kw).locations() == \
            JR.FileSplit(str(files), **kw).locations()
    assert TR.FileSplit(str(files / "svm.txt")).locations() == [str(files / "svm.txt")]


READERS = {
    "csv": (lambda M: M.CSVRecordReader(skip_num_lines=1), ("a", "b")),
    "csv_quoted": (lambda M: M.CSVRecordReader(), ("a/q.csv",)),
    "csv_delim": (lambda M: M.CSVRecordReader(delimiter=";"), ("a/q.csv",)),
    "line": (lambda M: M.LineRecordReader(), ("text.txt",)),
    "svmlight": (lambda M: M.SVMLightRecordReader(num_features=4), ("svm.txt",)),
    "regex": (lambda M: M.RegexLineRecordReader(r"id=(\d+) name=(\w+)", skip_num_lines=1),
              ("re.txt",)),
    "jackson": (lambda M: M.JacksonLineRecordReader(["a", "b", "c"]), ("j.jsonl",)),
    "excel": (lambda M: M.ExcelRecordReader(skip_num_rows=1), ("book.xlsx",)),
}


@pytest.mark.parametrize("name", list(READERS))
def test_reader_gives_jax_records(files, name):
    make, paths = READERS[name]
    out = []
    for M in (JR, TR):
        recs = []
        for p in paths:
            rr = make(M).initialize(M.FileSplit(str(files / p), allowed_extensions=[".csv"])
                                    if name == "csv" else M.FileSplit(str(files / p)))
            recs += list(rr)
            rr.reset()
            assert rr.has_next() == bool(recs)
        out.append(recs)
    assert out[0] == out[1] and out[1]


def test_reader_errors_match_jax(files):
    (files / "bad.txt").write_text("nomatch\n")
    (files / "svm_bad.txt").write_text("1 9:1.0\n")
    for M in (JR, TR):
        rr = M.RegexLineRecordReader(r"id=(\d+)").initialize(M.FileSplit(str(files / "bad.txt")))
        with pytest.raises(ValueError, match="does not match"):
            rr.next()
        sv = M.SVMLightRecordReader(3).initialize(M.FileSplit(str(files / "svm_bad.txt")))
        with pytest.raises(ValueError, match="outside"):
            sv.next()
        with pytest.raises(ValueError, match="out of range"):
            M.ExcelRecordReader(sheet_index=2).initialize(M.FileSplit(str(files / "book.xlsx")))


def test_collection_reader_and_load_csv_f32(files):
    recs = [[1, "a"], [2, "b"]]
    assert list(TR.CollectionRecordReader(recs).initialize()) == \
        list(JR.CollectionRecordReader(recs).initialize())
    path = str(files / "num.csv")
    rs = np.random.RandomState(1)
    np.savetxt(path, rs.rand(6, 3), delimiter=",", header="c0,c1,c2", comments="")
    got = TR.load_csv_f32(path, skip_rows=1)
    assert got.dtype == np.float32 and got.shape == (6, 3)
    np.testing.assert_array_equal(got, JR.load_csv_f32(path, skip_rows=1))
    assert TR.load_csv_f32(path) is None and JR.load_csv_f32(path) is None  # the header


@pytest.mark.parametrize("mode", ["classify", "regress", "features_only"])
def test_record_reader_dataset_iterator_matches_jax(files, mode):
    kw = {"classify": dict(label_index=-1, num_classes=3),
          "regress": dict(label_index=0, regression=True),
          "features_only": {}}[mode]
    got = []
    for M, MI in ((JR, JRI), (TR, TRI)):
        rr = M.CSVRecordReader(skip_num_lines=1).initialize(M.FileSplit(str(files / "a" / "x.csv")))
        it = MI.RecordReaderDataSetIterator(rr, batch_size=2, **kw)
        got.append([(np.asarray(d.features), None if d.labels is None else np.asarray(d.labels))
                    for d in it])
        assert it.batch() == 2
    assert len(got[0]) == len(got[1]) == 3
    for (jx, jy), (tx, ty) in zip(*got):
        np.testing.assert_array_equal(tx, jx)
        assert (jy is None) == (ty is None)
        if jy is not None:
            np.testing.assert_array_equal(ty, jy)
