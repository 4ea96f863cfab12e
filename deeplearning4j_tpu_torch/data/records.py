"""Record readers and input splits.

Counterpart of ``deeplearning4j_tpu/data/records.py`` (datavec-api: the
``RecordReader`` SPI over ``InputSplit`` sources, ``FileSplit``, and the
CSV, line, collection, SVMLight, regex, JSON-lines and Excel readers;
values are plain Python str/float). A copy: host code with no tensor.
``load_csv_f32`` parses with numpy; the JAX package binds its native
parser (``native/tnd.cpp``) when it is built, which the port does not have
(ROADMAP.md queue 1 item 8.8).
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Iterable, Iterator, List, Optional, Sequence


class InputSplit:
    def locations(self) -> List[str]:
        raise NotImplementedError


class FileSplit(InputSplit):
    """org.datavec.api.split.FileSplit: root dir or file (+ extension filter,
    recursive)."""

    def __init__(self, path: str, allowed_extensions: Optional[Sequence[str]] = None,
                 recursive: bool = True):
        self.path = path
        self.exts = tuple(allowed_extensions) if allowed_extensions else None
        self.recursive = recursive

    def locations(self) -> List[str]:
        if os.path.isfile(self.path):
            return [self.path]
        pattern = "**/*" if self.recursive else "*"
        files = [f for f in glob.glob(os.path.join(self.path, pattern), recursive=self.recursive)
                 if os.path.isfile(f)]
        if self.exts:
            files = [f for f in files if f.endswith(self.exts)]
        return sorted(files)


class ListStringSplit(InputSplit):
    def __init__(self, data: List[List[str]]):
        self.data = data

    def locations(self):
        return []


class RecordReader:
    """org.datavec.api.records.reader.RecordReader."""

    def initialize(self, split: InputSplit) -> "RecordReader":
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> List:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[List]:
        self.reset()
        while self.has_next():
            yield self.next()

    hasNext = has_next


class CSVRecordReader(RecordReader):
    """org.datavec.api.records.reader.impl.csv.CSVRecordReader: skip lines,
    delimiter, quote handling via csv module."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        self.skip = skip_num_lines
        self.delimiter = delimiter
        self._rows: List[List[str]] = []
        self._pos = 0

    def initialize(self, split: InputSplit) -> "CSVRecordReader":
        self._rows = []
        for path in split.locations():
            with open(path, newline="", encoding="utf-8") as f:
                rows = list(csv.reader(f, delimiter=self.delimiter))
            self._rows.extend(rows[self.skip:])
        self._pos = 0
        return self

    def has_next(self) -> bool:
        return self._pos < len(self._rows)

    def next(self) -> List[str]:
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def reset(self):
        self._pos = 0


class LineRecordReader(RecordReader):
    """impl.LineRecordReader: one record per line."""

    def __init__(self):
        self._lines: List[str] = []
        self._pos = 0

    def initialize(self, split: InputSplit) -> "LineRecordReader":
        self._lines = []
        for path in split.locations():
            with open(path, encoding="utf-8") as f:
                self._lines.extend(line.rstrip("\n") for line in f)
        self._pos = 0
        return self

    def has_next(self):
        return self._pos < len(self._lines)

    def next(self) -> List[str]:
        line = self._lines[self._pos]
        self._pos += 1
        return [line]

    def reset(self):
        self._pos = 0


class CollectionRecordReader(RecordReader):
    """impl.collection.CollectionRecordReader: records from memory."""

    def __init__(self, records: Iterable[List]):
        self._records = [list(r) for r in records]
        self._pos = 0

    def initialize(self, split: Optional[InputSplit] = None):
        self._pos = 0
        return self

    def has_next(self):
        return self._pos < len(self._records)

    def next(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


def load_csv_f32(path: str, delimiter: str = ",", skip_rows: int = 0):
    """Numeric-CSV load → float32 [rows, cols] with numpy (the JAX
    package's path when its native parser is not built). Returns None if
    the file is not purely numeric."""
    import numpy as np

    try:
        return np.loadtxt(path, delimiter=delimiter, skiprows=skip_rows,
                          dtype=np.float32, ndmin=2)
    except ValueError:
        return None


class LabeledFileRecordReader(RecordReader):
    """Shared scaffolding for file-per-example readers with directory-derived
    labels (image/audio): split filtering, sorted label index, sequential or
    index-addressed reads. Subclasses set ``_extensions`` and implement
    ``read_index``."""

    _extensions: tuple = ()

    def __init__(self, label_generator=None):
        self.label_gen = label_generator
        self._files: List[str] = []
        self._labels: List[str] = []
        self._label_idx: dict = {}
        self._i = 0

    def initialize(self, split: InputSplit):
        self._files = [f for f in split.locations()
                       if f.lower().endswith(self._extensions)]
        if self.label_gen is not None:
            self._labels = sorted({self.label_gen.label_for_path(f)
                                   for f in self._files})
            self._label_idx = {l: i for i, l in enumerate(self._labels)}
        self._i = 0
        return self

    def labels(self) -> List[str]:
        return list(self._labels)

    def num_labels(self) -> int:
        return len(self._labels)

    def has_next(self) -> bool:
        return self._i < len(self._files)

    def reset(self) -> None:
        self._i = 0

    def next(self) -> List:
        idx = self._i
        self._i += 1
        return self.read_index(idx)

    def take_indices(self, n: int) -> List[int]:
        """Claim the next n file indices (for batched parallel decode)."""
        start = self._i
        end = min(start + n, len(self._files))
        self._i = end
        return list(range(start, end))

    def _label_of(self, path: str) -> int:
        return self._label_idx[self.label_gen.label_for_path(path)]

    def read_index(self, idx: int) -> List:
        raise NotImplementedError


class SVMLightRecordReader(LineRecordReader):
    """datavec ``impl.misc.SVMLightRecordReader``: parse libsvm/SVMLight
    lines ``label idx:value idx:value ... [# comment]`` into dense rows
    ``[f0 .. f_{n-1}, label]`` (label last — the reference's writable
    layout). Indices are 1-based per the libsvm format; ``num_features``
    fixes the dense width; labels pass through unchanged (interpretation
    is the iterator's job, as in the reference)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.num_features = int(num_features)

    def next(self) -> List[float]:
        line = super().next()[0].strip()
        if "#" in line:
            line = line.split("#", 1)[0].strip()
        parts = line.split()
        row = [0.0] * self.num_features
        label = float(parts[0]) if parts else 0.0
        for tok in parts[1:]:
            idx, _, val = tok.partition(":")
            if idx == "qid":  # ranking extension ('label qid:N f:v ...')
                continue
            i = int(idx) - 1  # libsvm indices are 1-based
            if not 0 <= i < self.num_features:
                # the reference throws on out-of-range indices — dropping
                # them would silently train on corrupt all-zero rows
                raise ValueError(
                    f"SVMLight feature index {idx} outside "
                    f"[1, {self.num_features}] in line {line!r} "
                    "(wrong num_features, or 0-based data?)")
            row[i] = float(val)
        return row + [label]


class RegexLineRecordReader(LineRecordReader):
    """datavec ``impl.regex.RegexLineRecordReader``: each line matched
    against a regex; the capture groups become the record's columns.
    ``skip_num_lines`` skips headers; a non-matching line raises (the
    reference throws IllegalStateException)."""

    def __init__(self, regex: str, skip_num_lines: int = 0):
        super().__init__()
        import re

        self.pattern = re.compile(regex)
        self.skip_num_lines = skip_num_lines

    def initialize(self, split: InputSplit) -> "RegexLineRecordReader":
        # skip per FILE (the reference's behavior, and CSVRecordReader's in
        # this module): every file's header lines go, not just the first's
        self._lines = []
        for path in split.locations():
            with open(path, encoding="utf-8") as f:
                lines = [line.rstrip("\n") for line in f]
            self._lines.extend(lines[self.skip_num_lines:])
        self._pos = 0
        return self

    def next(self) -> List[str]:
        line = super().next()[0]
        m = self.pattern.fullmatch(line)  # whole line, Matcher.matches parity
        if m is None:
            raise ValueError(f"line does not match regex: {line!r}")
        return list(m.groups())


class JacksonLineRecordReader(LineRecordReader):
    """datavec ``impl.jackson.JacksonLineRecordReader``: one JSON object
    per line; ``field_selection`` names the fields (in order) that become
    the record's columns, with None for absent fields."""

    def __init__(self, field_selection: List[str]):
        super().__init__()
        self.field_selection = list(field_selection)

    def next(self) -> List:
        import json as _json

        obj = _json.loads(super().next()[0])
        return [obj.get(f) for f in self.field_selection]


class ExcelRecordReader(RecordReader):
    """datavec-excel ``ExcelRecordReader``: rows of the selected sheet of an
    .xlsx workbook become records.

    Self-contained: .xlsx is a zip of XML parts, read here with
    zipfile + ElementTree — no POI/openpyxl dependency, matching the
    importer-codec policy used for ONNX. Numeric cells parse to float,
    shared/inline strings to str; blank cells to ''.
    """

    _NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"

    def __init__(self, sheet_index: int = 0, skip_num_rows: int = 0):
        self.sheet_index = sheet_index
        self.skip_num_rows = skip_num_rows
        self._rows: List[List] = []
        self._pos = 0

    # -- xlsx parsing ------------------------------------------------------

    @staticmethod
    def _col_index(ref: str) -> int:
        """'C7' → 2 (column letters to 0-based index)."""
        n = 0
        for ch in ref:
            if ch.isalpha():
                n = n * 26 + (ord(ch.upper()) - ord("A") + 1)
            else:
                break
        return n - 1

    def _parse(self, path: str) -> List[List]:
        import xml.etree.ElementTree as ET
        import zipfile

        ns = self._NS
        with zipfile.ZipFile(path) as z:
            shared: List[str] = []
            if "xl/sharedStrings.xml" in z.namelist():
                root = ET.fromstring(z.read("xl/sharedStrings.xml"))
                for si in root.findall(f"{ns}si"):
                    shared.append("".join(t.text or "" for t in si.iter(f"{ns}t")))
            # numeric order: lexicographic sort puts sheet10 before sheet2
            sheets = sorted(
                (n for n in z.namelist()
                 if n.startswith("xl/worksheets/sheet") and n.endswith(".xml")),
                key=lambda n: int(n[len("xl/worksheets/sheet"):-len(".xml")] or 0))
            if self.sheet_index >= len(sheets):
                raise ValueError(f"sheet {self.sheet_index} out of range "
                                 f"({len(sheets)} sheets)")
            root = ET.fromstring(z.read(sheets[self.sheet_index]))
            rows = []
            for row in root.iter(f"{ns}row"):
                cells: List = []
                for c in row.findall(f"{ns}c"):
                    ref = c.get("r", "")
                    idx = self._col_index(ref) if ref else len(cells)
                    while len(cells) < idx:
                        cells.append("")     # gap → blank cell
                    ctype = c.get("t", "n")
                    v = c.find(f"{ns}v")
                    if ctype == "s":         # shared string
                        cells.append(shared[int(v.text)] if v is not None else "")
                    elif ctype == "inlineStr":
                        cells.append("".join(t.text or ""
                                             for t in c.iter(f"{ns}t")))
                    elif v is None or v.text is None:
                        cells.append("")
                    else:
                        cells.append(float(v.text))
                rows.append(cells)
            return rows

    # -- RecordReader ------------------------------------------------------

    def initialize(self, split: InputSplit) -> "ExcelRecordReader":
        self._rows = []
        for path in split.locations():
            self._rows.extend(self._parse(path)[self.skip_num_rows:])
        self._pos = 0
        return self

    def has_next(self) -> bool:
        return self._pos < len(self._rows)

    def next(self) -> List:
        r = self._rows[self._pos]
        self._pos += 1
        return r

    def reset(self) -> None:
        self._pos = 0
