"""Schema + TransformProcess — dataframe-style typed transforms (copy of
the JAX package's ``data.transform``, host Python over rows: the same rows
in give the same rows out, and ``to_json`` writes the same text, so a
process saved by either package loads in the other).

Reference: datavec ``org.datavec.api.transform.TransformProcess`` over a
``schema.Schema``: categorical/one-hot conversion, normalization ops,
string/math column ops, time parsing and derived time fields, conditional
replace/copy/filter, keyed reductions, joins, the data and data-quality
analyses and the sequence helpers — all JSON-serializable (the
serialization invariant gives versioned pipelines). Nothing here imports
torch: the ETL service's spawned workers may import it.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence


class ColumnType:
    STRING = "String"
    INTEGER = "Integer"
    DOUBLE = "Double"
    CATEGORICAL = "Categorical"
    LONG = "Long"


class Schema:
    """org.datavec.api.transform.schema.Schema (+Builder)."""

    def __init__(self, columns: Optional[List[Dict[str, Any]]] = None):
        self.columns = columns or []

    class Builder:
        def __init__(self):
            self._cols: List[Dict[str, Any]] = []

        def add_column_string(self, name: str):
            self._cols.append({"name": name, "type": ColumnType.STRING})
            return self

        addColumnString = add_column_string

        def add_column_integer(self, name: str):
            self._cols.append({"name": name, "type": ColumnType.INTEGER})
            return self

        addColumnInteger = add_column_integer

        def add_column_double(self, name: str):
            self._cols.append({"name": name, "type": ColumnType.DOUBLE})
            return self

        addColumnDouble = add_column_double

        def add_column_categorical(self, name: str, *states: str):
            self._cols.append({"name": name, "type": ColumnType.CATEGORICAL,
                               "states": list(states)})
            return self

        addColumnCategorical = add_column_categorical

        def build(self) -> "Schema":
            return Schema(list(self._cols))

    def names(self) -> List[str]:
        return [c["name"] for c in self.columns]

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c["name"] == name:
                return i
        raise KeyError(name)

    def column(self, name: str) -> Dict[str, Any]:
        return self.columns[self.index_of(name)]

    def to_json(self) -> str:
        return json.dumps({"columns": self.columns})

    @staticmethod
    def from_json(s: str) -> "Schema":
        return Schema(json.loads(s)["columns"])


# ------------------------------------------------------------------- steps


_STEP_REGISTRY: Dict[str, Callable] = {}


def _step(name):
    def deco(cls):
        _STEP_REGISTRY[name] = cls
        cls.step_name = name
        return cls

    return deco


class _Step:
    def apply_schema(self, schema: Schema) -> Schema:
        return schema

    def apply(self, rows: List[List], schema: Schema) -> List[List]:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = dict(self.__dict__)
        d["@step"] = self.step_name
        return d

    @staticmethod
    def from_json(d: dict) -> "_Step":
        d = dict(d)
        cls = _STEP_REGISTRY[d.pop("@step")]
        obj = cls.__new__(cls)
        obj.__dict__.update(d)
        return obj


@_step("remove_columns")
class _RemoveColumns(_Step):
    def __init__(self, names):
        self.names = list(names)

    def apply_schema(self, schema):
        return Schema([c for c in schema.columns if c["name"] not in self.names])

    def apply(self, rows, schema):
        idxs = [schema.index_of(n) for n in self.names]
        keep = [i for i in range(len(schema.columns)) if i not in idxs]
        return [[r[i] for i in keep] for r in rows]


@_step("rename_column")
class _RenameColumn(_Step):
    def __init__(self, old, new):
        self.old, self.new = old, new

    def apply_schema(self, schema):
        cols = [dict(c) for c in schema.columns]
        cols[schema.index_of(self.old)]["name"] = self.new
        return Schema(cols)

    def apply(self, rows, schema):
        return rows


@_step("categorical_to_integer")
class _CatToInt(_Step):
    def __init__(self, name):
        self.name = name

    def apply_schema(self, schema):
        cols = [dict(c) for c in schema.columns]
        i = schema.index_of(self.name)
        cols[i] = {"name": self.name, "type": ColumnType.INTEGER,
                   "states": cols[i].get("states")}
        return Schema(cols)

    def apply(self, rows, schema):
        i = schema.index_of(self.name)
        states = schema.column(self.name).get("states") or []
        lut = {s: j for j, s in enumerate(states)}
        out = []
        for r in rows:
            r = list(r)
            r[i] = lut[r[i]]
            out.append(r)
        return out


@_step("categorical_to_one_hot")
class _CatToOneHot(_Step):
    def __init__(self, name):
        self.name = name

    def apply_schema(self, schema):
        i = schema.index_of(self.name)
        states = schema.column(self.name).get("states") or []
        cols = [dict(c) for c in schema.columns]
        onehot = [{"name": f"{self.name}[{s}]", "type": ColumnType.INTEGER} for s in states]
        return Schema(cols[:i] + onehot + cols[i + 1:])

    def apply(self, rows, schema):
        i = schema.index_of(self.name)
        states = schema.column(self.name).get("states") or []
        out = []
        for r in rows:
            oh = [1 if r[i] == s else 0 for s in states]
            out.append(list(r[:i]) + oh + list(r[i + 1:]))
        return out


@_step("double_math_op")
class _DoubleMathOp(_Step):
    OPS = {"Add": lambda a, b: a + b, "Subtract": lambda a, b: a - b,
           "Multiply": lambda a, b: a * b, "Divide": lambda a, b: a / b,
           "Pow": lambda a, b: a ** b}

    def __init__(self, name, op, scalar):
        self.name, self.op, self.scalar = name, op, scalar

    def apply(self, rows, schema):
        i = schema.index_of(self.name)
        f = self.OPS[self.op]
        out = []
        for r in rows:
            r = list(r)
            r[i] = f(float(r[i]), self.scalar)
            out.append(r)
        return out


@_step("string_map")
class _StringMap(_Step):
    TRANSFORMS = {"lower": str.lower, "upper": str.upper, "strip": str.strip}

    def __init__(self, name, transform):
        self.name, self.transform = name, transform

    def apply(self, rows, schema):
        i = schema.index_of(self.name)
        f = self.TRANSFORMS[self.transform]
        out = []
        for r in rows:
            r = list(r)
            r[i] = f(str(r[i]))
            out.append(r)
        return out


@_step("filter_invalid")
class _FilterInvalid(_Step):
    """Drop rows whose numeric columns fail to parse (condition filter)."""

    def __init__(self, names):
        self.names = list(names)

    def apply(self, rows, schema):
        idxs = [schema.index_of(n) for n in self.names]
        out = []
        for r in rows:
            try:
                for i in idxs:
                    float(r[i])
                out.append(r)
            except (TypeError, ValueError):
                pass
        return out


@_step("convert_to_double")
class _ConvertDouble(_Step):
    def __init__(self, names):
        self.names = list(names)

    def apply_schema(self, schema):
        cols = [dict(c) for c in schema.columns]
        for n in self.names:
            cols[schema.index_of(n)]["type"] = ColumnType.DOUBLE
        return Schema(cols)

    def apply(self, rows, schema):
        idxs = [schema.index_of(n) for n in self.names]
        out = []
        for r in rows:
            r = list(r)
            for i in idxs:
                r[i] = float(r[i])
            out.append(r)
        return out


# ----------------------------------------------------------------- process


class TransformProcess:
    """Builder-pattern pipeline over a Schema; executable locally
    (LocalTransformExecutor parity) and JSON round-trippable."""

    def __init__(self, initial_schema: Schema, steps: Optional[List[_Step]] = None):
        self.initial_schema = initial_schema
        self.steps = steps or []

    class Builder:
        def __init__(self, schema: Schema):
            self._schema = schema
            self._steps: List[_Step] = []

        def remove_columns(self, *names):
            self._steps.append(_RemoveColumns(names))
            return self

        removeColumns = remove_columns

        def rename_column(self, old, new):
            self._steps.append(_RenameColumn(old, new))
            return self

        renameColumn = rename_column

        def categorical_to_integer(self, name):
            self._steps.append(_CatToInt(name))
            return self

        categoricalToInteger = categorical_to_integer

        def categorical_to_one_hot(self, name):
            self._steps.append(_CatToOneHot(name))
            return self

        categoricalToOneHot = categorical_to_one_hot

        def double_math_op(self, name, op, scalar):
            self._steps.append(_DoubleMathOp(name, op, scalar))
            return self

        doubleMathOp = double_math_op

        def string_map_transform(self, name, transform):
            self._steps.append(_StringMap(name, transform))
            return self

        def filter_invalid(self, *names):
            self._steps.append(_FilterInvalid(names))
            return self

        def convert_to_double(self, *names):
            self._steps.append(_ConvertDouble(names))
            return self

        convertToDouble = convert_to_double

        def string_to_time(self, name, fmt="%Y-%m-%d %H:%M:%S"):
            self._steps.append(_StringToTime(name, fmt))
            return self

        stringToTimeTransform = string_to_time

        def derive_time_fields(self, name, *fields):
            self._steps.append(_DeriveTimeFields(name, fields or ("hourOfDay", "dayOfWeek")))
            return self

        def conditional_replace(self, name, cond_op, cond_value, replacement):
            self._steps.append(_ConditionalReplace(name, cond_op, cond_value, replacement))
            return self

        conditionalReplaceValueTransform = conditional_replace

        def filter_by_condition(self, name, cond_op, cond_value):
            self._steps.append(_FilterByCondition(name, cond_op, cond_value))
            return self

        def reduce(self, reducer: "Reducer"):
            self._steps.append(_Reduce(reducer.keys, reducer.ops))
            return self

        def columns_math_op(self, new_name, op, *columns):
            self._steps.append(_ColumnsMathOp(new_name, op, columns))
            return self

        doubleColumnsMathOp = columns_math_op

        def conditional_copy(self, column, source_column, cond_column,
                             cond_op, cond_value):
            self._steps.append(_ConditionalCopy(column, source_column,
                                                cond_column, cond_op, cond_value))
            return self

        conditionalCopyValueTransform = conditional_copy

        def build(self) -> "TransformProcess":
            return TransformProcess(self._schema, list(self._steps))

    def final_schema(self) -> Schema:
        schema = self.initial_schema
        for s in self.steps:
            schema = s.apply_schema(schema)
        return schema

    getFinalSchema = final_schema

    def execute(self, rows: List[List]) -> List[List]:
        schema = self.initial_schema
        for s in self.steps:
            rows = s.apply(rows, schema)
            schema = s.apply_schema(schema)
        return rows

    def to_json(self) -> str:
        return json.dumps({
            "initial_schema": json.loads(self.initial_schema.to_json()),
            "steps": [s.to_json() for s in self.steps],
        })

    @staticmethod
    def from_json(s: str) -> "TransformProcess":
        d = json.loads(s)
        return TransformProcess(
            Schema(d["initial_schema"]["columns"]),
            [_Step.from_json(sd) for sd in d["steps"]],
        )


# ------------------------------------------------------- more step kinds


@_step("string_to_time")
class _StringToTime(_Step):
    """org.datavec transform.time.StringToTimeTransform: parse a string
    column into epoch milliseconds (LongColumn)."""

    def __init__(self, name, fmt="%Y-%m-%d %H:%M:%S"):
        self.name = name
        self.fmt = fmt

    def apply_schema(self, schema):
        cols = [dict(c) for c in schema.columns]
        cols[schema.index_of(self.name)]["type"] = ColumnType.LONG
        return Schema(cols)

    def apply(self, rows, schema):
        import datetime as _dt

        i = schema.index_of(self.name)
        out = []
        for r in rows:
            r = list(r)
            t = _dt.datetime.strptime(str(r[i]), self.fmt)
            r[i] = int(t.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000)
            out.append(r)
        return out


@_step("derive_time_fields")
class _DeriveTimeFields(_Step):
    """transform.time.DeriveColumnsFromTimeTransform: append hour-of-day /
    day-of-week integer columns from an epoch-ms column."""

    def __init__(self, name, fields=("hourOfDay", "dayOfWeek")):
        self.name = name
        self.fields = list(fields)

    def apply_schema(self, schema):
        cols = [dict(c) for c in schema.columns]
        for f in self.fields:
            cols.append({"name": f"{self.name}_{f}", "type": ColumnType.INTEGER})
        return Schema(cols)

    def apply(self, rows, schema):
        import datetime as _dt

        i = schema.index_of(self.name)
        out = []
        for r in rows:
            t = _dt.datetime.fromtimestamp(int(r[i]) / 1000.0, _dt.timezone.utc)
            extra = []
            for f in self.fields:
                if f == "hourOfDay":
                    extra.append(t.hour)
                elif f == "dayOfWeek":
                    extra.append(t.weekday())
                elif f == "monthOfYear":
                    extra.append(t.month)
                else:
                    raise ValueError(f"unknown time field {f}")
            out.append(list(r) + extra)
        return out


@_step("conditional_replace")
class _ConditionalReplace(_Step):
    """transform.condition ConditionalReplaceValueTransform: replace a
    column's value where a (column, op, value) condition holds."""

    _OPS = {"lt": lambda a, b: a < b, "lte": lambda a, b: a <= b,
            "gt": lambda a, b: a > b, "gte": lambda a, b: a >= b,
            "eq": lambda a, b: a == b, "neq": lambda a, b: a != b}

    def __init__(self, name, cond_op, cond_value, replacement):
        self.name = name
        self.cond_op = cond_op
        self.cond_value = cond_value
        self.replacement = replacement

    @staticmethod
    def _holds(op_name, value, cond_value):
        """Numeric compare when both sides parse; eq/neq fall back to string
        equality; ORDERING ops on unparseable values are False (lexicographic
        ordering of numeric-typed strings gives wrong answers silently)."""
        op = _ConditionalReplace._OPS[op_name]
        try:
            return op(float(value), float(cond_value))
        except (TypeError, ValueError):
            if op_name in ("eq", "neq"):
                return op(str(value), str(cond_value))
            return False

    def apply(self, rows, schema):
        i = schema.index_of(self.name)
        out = []
        for r in rows:
            r = list(r)
            if self._holds(self.cond_op, r[i], self.cond_value):
                r[i] = self.replacement
            out.append(r)
        return out


@_step("filter_by_condition")
class _FilterByCondition(_Step):
    """transform.filter.ConditionFilter: DROP rows where the condition holds."""

    def __init__(self, name, cond_op, cond_value):
        self.name = name
        self.cond_op = cond_op
        self.cond_value = cond_value

    def apply(self, rows, schema):
        i = schema.index_of(self.name)
        return [r for r in rows
                if not _ConditionalReplace._holds(self.cond_op, r[i],
                                                  self.cond_value)]


def join(left_schema: Schema, left_rows, right_schema: Schema, right_rows,
         key: str, join_type: str = "Inner"):
    """org.datavec.api.transform.join.Join (Inner/LeftOuter): returns
    (schema, rows) with the right side's non-key columns appended."""
    if join_type not in ("Inner", "LeftOuter"):
        raise ValueError(join_type)
    li = left_schema.index_of(key)
    ri = right_schema.index_of(key)
    rcols = [c for j, c in enumerate(right_schema.columns) if j != ri]
    clash = {c["name"] for c in left_schema.columns} & {c["name"] for c in rcols}
    if clash:
        raise ValueError(
            f"join would duplicate column names {sorted(clash)} — rename one "
            "side first (Schema.index_of resolves the first match silently)")
    out_schema = Schema([dict(c) for c in left_schema.columns]
                        + [dict(c) for c in rcols])
    index: Dict[Any, List] = {}
    for r in right_rows:
        index.setdefault(r[ri], []).append(
            [v for j, v in enumerate(r) if j != ri])
    rows = []
    pad = [None] * len(rcols)
    for l in left_rows:
        matches = index.get(l[li])
        if matches:
            for m in matches:
                rows.append(list(l) + m)
        elif join_type == "LeftOuter":
            rows.append(list(l) + pad)
    return out_schema, rows


class DataAnalysis:
    """org.datavec.api.transform.analysis.DataAnalysis (AnalyzeLocal):
    per-column stats over (schema, rows)."""

    def __init__(self, schema: Schema, column_stats: Dict[str, Dict[str, Any]]):
        self.schema = schema
        self.column_stats = column_stats

    @staticmethod
    def analyze(schema: Schema, rows) -> "DataAnalysis":
        import numpy as _np

        stats: Dict[str, Dict[str, Any]] = {}
        for j, col in enumerate(schema.columns):
            vals = [r[j] for r in rows]
            if col["type"] in (ColumnType.INTEGER, ColumnType.DOUBLE,
                               ColumnType.LONG):
                parsed = []
                for v in vals:
                    try:
                        parsed.append(float(v))
                    except (TypeError, ValueError):
                        pass  # unparseable numeric → counted as missing
                arr = _np.asarray(parsed, _np.float64)
                stats[col["name"]] = {
                    "count": int(arr.size),
                    "min": float(arr.min()) if arr.size else None,
                    "max": float(arr.max()) if arr.size else None,
                    "mean": float(arr.mean()) if arr.size else None,
                    "std": float(arr.std()) if arr.size else None,
                    "countMissing": len(vals) - int(arr.size),
                }
            else:
                uniq: Dict[str, int] = {}
                for v in vals:
                    uniq[str(v)] = uniq.get(str(v), 0) + 1
                stats[col["name"]] = {
                    "count": len(vals),
                    "countUnique": len(uniq),
                    "topByCount": sorted(uniq, key=uniq.get, reverse=True)[:5],
                }
        return DataAnalysis(schema, stats)

    def to_json(self) -> str:
        return json.dumps({"columns": self.column_stats})


# ------------------------------------------- joins, analyses and reductions
# Reductions, sequence ops, dual-column math, conditional copy, and quality
# analysis (ref: org.datavec.api.transform.reduce.Reducer,
# transform.sequence.*, transform.doubletransform.DoubleColumnsMathOpTransform,
# analysis.quality.DataQualityAnalysis).

import numpy as np  # noqa: E402  (reduction math)

_REDUCTIONS = {
    "sum": lambda v: float(np.sum(v)) if len(v) else 0.0,
    "mean": lambda v: float(np.mean(v)) if len(v) else float("nan"),
    "min": lambda v: float(np.min(v)) if len(v) else float("nan"),
    "max": lambda v: float(np.max(v)) if len(v) else float("nan"),
    "stdev": lambda v: float(np.std(v, ddof=1)) if len(v) > 1 else 0.0,
    "range": lambda v: float(np.max(v) - np.min(v)) if len(v) else 0.0,
    "count": len,
    "count_unique": lambda v: len(set(v)),
    "first": lambda v: v[0] if len(v) else None,
    "last": lambda v: v[-1] if len(v) else None,
}
_NUMERIC_REDUCTIONS = {"sum", "mean", "min", "max", "stdev", "range"}


class Reducer:
    """org.datavec.api.transform.reduce.Reducer: group rows by key columns,
    reduce every other selected column with a per-column op."""

    def __init__(self, keys: List[str], ops: Dict[str, str]):
        self.keys = list(keys)
        self.ops = dict(ops)  # column name -> reduction op name

    class Builder:
        def __init__(self, *keys: str):
            self._keys = list(keys)
            self._ops: Dict[str, str] = {}

        def _add(self, op, names):
            for n in names:
                self._ops[n] = op
            return self

        def sum_columns(self, *names):
            return self._add("sum", names)

        def mean_columns(self, *names):
            return self._add("mean", names)

        def min_columns(self, *names):
            return self._add("min", names)

        def max_columns(self, *names):
            return self._add("max", names)

        def stdev_columns(self, *names):
            return self._add("stdev", names)

        def range_columns(self, *names):
            return self._add("range", names)

        def count_columns(self, *names):
            return self._add("count", names)

        def count_unique_columns(self, *names):
            return self._add("count_unique", names)

        def take_first_columns(self, *names):
            return self._add("first", names)

        def take_last_columns(self, *names):
            return self._add("last", names)

        sumColumns = sum_columns
        meanColumns = mean_columns
        minColumns = min_columns
        maxColumns = max_columns
        stdevColumns = stdev_columns
        countColumns = count_columns
        takeFirstColumns = take_first_columns
        takeLastColumns = take_last_columns

        def build(self) -> "Reducer":
            return Reducer(self._keys, self._ops)


@_step("reduce")
class _Reduce(_Step):
    def __init__(self, keys, ops):
        self.keys = list(keys)
        self.ops = dict(ops)

    def apply_schema(self, schema):
        # KEY columns first, in key order — matching the row layout apply()
        # produces (schema index_of must agree with the data positions)
        cols = [dict(schema.column(k)) for k in self.keys]
        for c in schema.columns:
            n = c["name"]
            if n in self.keys:
                continue
            if n in self.ops:
                op = self.ops[n]
                t = (ColumnType.DOUBLE if op in _NUMERIC_REDUCTIONS
                     else ColumnType.INTEGER if op in ("count", "count_unique")
                     else c["type"])
                cols.append({"name": f"{op}({n})", "type": t})
        return Schema(cols)

    def apply(self, rows, schema):
        key_idx = [schema.index_of(k) for k in self.keys]
        val_cols = [(schema.index_of(n), n, self.ops[n])
                    for c in schema.columns
                    for n in [c["name"]] if n in self.ops]
        groups: Dict[tuple, List[List]] = {}
        order: List[tuple] = []
        for r in rows:
            k = tuple(r[i] for i in key_idx)
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(r)
        out = []
        for k in order:
            grp = groups[k]
            row = list(k)
            for i, n, op in val_cols:
                vals = [g[i] for g in grp]
                if op in _NUMERIC_REDUCTIONS:
                    vals = [float(v) for v in vals]
                row.append(_REDUCTIONS[op](vals))
            out.append(row)
        return out


@_step("columns_math_op")
class _ColumnsMathOp(_Step):
    """DoubleColumnsMathOpTransform: newCol = colA <op> colB (+ more cols
    for add/mul)."""

    # IEEE double semantics like the reference's Java doubles: divide/mod by
    # zero yields inf/nan, not an exception killing the batch
    _OPS = {"add": lambda a, b: float(a + b), "subtract": lambda a, b: float(a - b),
            "multiply": lambda a, b: float(a * b),
            "divide": lambda a, b: float(np.float64(a) / np.float64(b)),
            "modulus": lambda a, b: float(np.mod(np.float64(a), np.float64(b)))}

    def __init__(self, new_name, op, columns):
        self.new_name = new_name
        self.op = op
        self.columns = list(columns)

    def apply_schema(self, schema):
        return Schema(schema.columns
                      + [{"name": self.new_name, "type": ColumnType.DOUBLE}])

    def apply(self, rows, schema):
        idxs = [schema.index_of(n) for n in self.columns]
        f = self._OPS[self.op]
        out = []
        with np.errstate(divide="ignore", invalid="ignore"):
            for r in rows:
                acc = float(r[idxs[0]])
                for i in idxs[1:]:
                    acc = f(acc, float(r[i]))
                out.append(list(r) + [acc])
        return out


@_step("conditional_copy")
class _ConditionalCopy(_Step):
    """ConditionalCopyValueTransform: when the condition on ``cond_column``
    holds, replace ``column``'s value with ``source_column``'s."""

    def __init__(self, column, source_column, cond_column, cond_op, cond_value):
        self.column = column
        self.source_column = source_column
        self.cond_column = cond_column
        self.cond_op = cond_op
        self.cond_value = cond_value

    def apply(self, rows, schema):
        i = schema.index_of(self.column)
        s = schema.index_of(self.source_column)
        c = schema.index_of(self.cond_column)
        out = []
        for r in rows:
            r = list(r)
            if _ConditionalReplace._holds(self.cond_op, r[c], self.cond_value):
                r[i] = r[s]
            out.append(r)
        return out


# ------------------------------------------------------------ sequence ops
# DL4J sequences are List[steps] of List[values]; a sequence dataset is
# List[sequence]. ``convert_to_sequence`` is the rows→sequences boundary.


def convert_to_sequence(schema: Schema, rows: List[List], key_column: str,
                        sort_column: Optional[str] = None) -> List[List[List]]:
    """transform.sequence.ConvertToSequence: group by key, sort within each
    group by ``sort_column`` (NumericalColumnComparator)."""
    k = schema.index_of(key_column)
    s = schema.index_of(sort_column) if sort_column else None
    groups: Dict[Any, List[List]] = {}
    order: List[Any] = []
    for r in rows:
        key = r[k]
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(list(r))
    out = []
    for key in order:
        seq = groups[key]
        if s is not None:
            seq.sort(key=lambda r: float(r[s]))
        out.append(seq)
    return out


class SplitMaxLengthSequence:
    """sequence.split.SplitMaxLengthSequence: chop into chunks of at most
    ``max_length`` steps."""

    def __init__(self, max_length: int):
        self.max_length = int(max_length)

    def split(self, seq: List[List]) -> List[List[List]]:
        return [seq[i:i + self.max_length]
                for i in range(0, len(seq), self.max_length)]


def split_sequences(seqs: List[List[List]], splitter) -> List[List[List]]:
    out = []
    for s in seqs:
        out.extend(splitter.split(s))
    return out


def offset_sequence(schema: Schema, seqs: List[List[List]], columns: List[str],
                    offset: int, mode: str = "in_place") -> List[List[List]]:
    """sequence.SequenceOffsetTransform: shift the listed columns by
    ``offset`` steps within each sequence (positive = values come from
    earlier steps — lag features). Steps whose shifted source falls outside
    the sequence are trimmed (the reference's EdgeHandling.TrimSequence).

    ``mode``: "in_place" overwrites the listed columns (OperationType.
    InPlace); "new_column" appends the shifted values as trailing columns,
    one per listed column in order (OperationType.NewColumn)."""
    if mode not in ("in_place", "new_column"):
        raise ValueError(f"offset_sequence mode {mode!r}: "
                         "expected 'in_place' or 'new_column'")
    idxs = [schema.index_of(n) for n in columns]
    out = []
    for seq in seqs:
        n = len(seq)
        lo, hi = (offset, n) if offset >= 0 else (0, n + offset)
        new_seq = []
        for t in range(lo, hi):
            row = list(seq[t])
            if mode == "in_place":
                for i in idxs:
                    row[i] = seq[t - offset][i]
            else:
                row.extend(seq[t - offset][i] for i in idxs)
            new_seq.append(row)
        if new_seq:
            out.append(new_seq)
    return out


def reduce_sequence_by_window(schema: Schema,
                              seqs: List[List[List]], window: int,
                              reducer: Reducer) -> List[List[List]]:
    """sequence.window.ReduceSequenceByWindowTransform with a count-based
    window: partition each sequence into ``window``-step chunks and reduce
    each chunk to one row with the reducer's per-column ops (keys pass
    through from the chunk's first row)."""
    key_idx = [schema.index_of(k) for k in reducer.keys]
    val_cols = [(schema.index_of(n), n, reducer.ops[n])
                for c in schema.columns
                for n in [c["name"]] if n in reducer.ops]
    out = []
    for seq in seqs:
        new_seq = []
        for i in range(0, len(seq), window):
            chunk = seq[i:i + window]
            row = [chunk[0][k] for k in key_idx]
            for ci, n, op in val_cols:
                vals = [r[ci] for r in chunk]
                if op in _NUMERIC_REDUCTIONS:
                    vals = [float(v) for v in vals]
                row.append(_REDUCTIONS[op](vals))
            new_seq.append(row)
        out.append(new_seq)
    return out


# ------------------------------------------------------- quality analysis


class ColumnQuality:
    def __init__(self, valid=0, invalid=0, missing=0, total=0):
        self.valid = valid
        self.invalid = invalid
        self.missing = missing
        self.total = total

    def to_dict(self):
        return {"valid": self.valid, "invalid": self.invalid,
                "missing": self.missing, "total": self.total}


class DataQualityAnalysis:
    """analysis.quality.DataQualityAnalysis (QualityAnalyzeLocal): per-column
    valid/invalid/missing counts — numeric columns check parseability and
    finiteness, categorical columns check state membership."""

    def __init__(self, schema: Schema, column_quality: Dict[str, ColumnQuality]):
        self.schema = schema
        self.column_quality = column_quality

    @staticmethod
    def analyze(schema: Schema, rows: List[List]) -> "DataQualityAnalysis":
        import math

        qual = {c["name"]: ColumnQuality() for c in schema.columns}
        for r in rows:
            for j, c in enumerate(schema.columns):
                q = qual[c["name"]]
                q.total += 1
                v = r[j] if j < len(r) else None
                if v is None or (isinstance(v, str) and v == ""):
                    q.missing += 1
                    continue
                if c["type"] in (ColumnType.INTEGER, ColumnType.DOUBLE,
                                 ColumnType.LONG):
                    try:
                        f = float(v)
                        if math.isfinite(f):
                            q.valid += 1
                        else:
                            q.invalid += 1
                    except (TypeError, ValueError):
                        q.invalid += 1
                elif c["type"] == ColumnType.CATEGORICAL:
                    states = c.get("states") or []
                    if not states or v in states:
                        q.valid += 1
                    else:
                        q.invalid += 1
                else:
                    q.valid += 1
        return DataQualityAnalysis(schema, qual)

    def to_json(self) -> str:
        return json.dumps({n: q.to_dict() for n, q in self.column_quality.items()})
