"""Data types with nd4j's promotion rules.

Counterpart of ``deeplearning4j_tpu/common/dtypes.py``: the same
:class:`DataType` members and values, and the same promotion ladder
(:func:`promote_types`). ``.torch`` and :func:`to_torch`/:func:`from_torch`
take the place of the JAX package's ``.jax`` and ``to_jax``/``from_jax``.

``UINT16``, ``UINT32`` and ``UINT64`` map to ``torch.uint16``/``uint32``/
``uint64``. Those types exist, but few PyTorch operators take them (not
even an addition on the CPU): they serve to hold and move data, and a
tensor of them is cast before any arithmetic. numpy has no bfloat16, so
``DataType.BFLOAT16.np`` raises; use ``.torch``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    """nd4j's public dtype enum (org.nd4j.linalg.api.buffer.DataType)."""

    DOUBLE = "float64"
    FLOAT = "float32"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    LONG = "int64"
    INT = "int32"
    SHORT = "int16"
    BYTE = "int8"
    UBYTE = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    BOOL = "bool"
    # UTF8 / COMPRESSED are left out, as in the JAX package: no string tensors

    @property
    def torch(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def np(self):
        if self is DataType.BFLOAT16:
            raise TypeError("numpy has no bfloat16; use DataType.BFLOAT16.torch")
        return np.dtype(self.value)

    def is_fp(self) -> bool:
        return self in _FLOATS

    def is_int(self) -> bool:
        return self in _INTS

    def is_signed(self) -> bool:
        return self in _SIGNED

    @property
    def width(self) -> int:
        """Bytes per element (DataTypeUtils::sizeOf)."""
        return self.torch.itemsize

    def __repr__(self):  # nd4j's terse enum printing
        return self.name


_FLOATS = {DataType.DOUBLE, DataType.FLOAT, DataType.HALF, DataType.BFLOAT16}
_INTS = {
    DataType.LONG,
    DataType.INT,
    DataType.SHORT,
    DataType.BYTE,
    DataType.UBYTE,
    DataType.UINT16,
    DataType.UINT32,
    DataType.UINT64,
}
_SIGNED = _FLOATS | {DataType.LONG, DataType.INT, DataType.SHORT, DataType.BYTE}

_TORCH_TO_DT = {dt.torch: dt for dt in DataType}

# nd4j promotion ladder (DataTypeUtils::pickPairwiseResultType): float beats
# int beats bool; within a family the wider type wins; HALF+BFLOAT16 -> FLOAT
# (no common 16-bit superset).
_FP_RANK = {
    DataType.BFLOAT16: 1,
    DataType.HALF: 1,
    DataType.FLOAT: 2,
    DataType.DOUBLE: 3,
}
_INT_RANK = {
    DataType.BYTE: 1,
    DataType.UBYTE: 1,
    DataType.SHORT: 2,
    DataType.UINT16: 2,
    DataType.INT: 3,
    DataType.UINT32: 3,
    DataType.LONG: 4,
    DataType.UINT64: 4,
}


def promote_types(a: DataType, b: DataType) -> DataType:
    """Pairwise result type, nd4j rules (DataTypeUtils::pickPairwiseResultType)."""
    if a == b:
        return a
    if a.is_fp() or b.is_fp():
        if a.is_fp() and b.is_fp():
            if _FP_RANK[a] == _FP_RANK[b]:  # HALF vs BFLOAT16
                return DataType.FLOAT
            return a if _FP_RANK[a] > _FP_RANK[b] else b
        return a if a.is_fp() else b
    if a.is_int() or b.is_int():
        if a.is_int() and b.is_int():
            if _INT_RANK[a] == _INT_RANK[b]:  # signed/unsigned same width
                return a if a.is_signed() else b
            return a if _INT_RANK[a] > _INT_RANK[b] else b
        return a if a.is_int() else b
    return DataType.BOOL


def to_torch(dt) -> torch.dtype:
    """DataType, its name or value, a numpy dtype or a torch dtype -> torch dtype."""
    if isinstance(dt, DataType):
        return dt.torch
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        try:
            return DataType[dt.upper()].torch
        except KeyError:
            return _from_name(dt).torch
    return _from_name(np.dtype(dt).name).torch


def _from_name(name: str) -> DataType:
    try:
        return DataType(name)
    except ValueError:
        raise TypeError(f"unsupported dtype {name}") from None


def from_torch(dtype) -> DataType:
    dt = _TORCH_TO_DT.get(dtype) if isinstance(dtype, torch.dtype) else None
    if dt is None:
        raise TypeError(f"unsupported dtype {dtype}")
    return dt
