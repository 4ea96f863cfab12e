"""Gradient compression: threshold and bitmap encoding (DL4J's N15 codecs).

Counterpart of ``deeplearning4j_tpu/parallel/compression.py`` (libnd4j
``encodeThresholdP1/P2/P3``, ``encodeBitmap``, ``decodeThreshold``,
``decodeBitmap``): the sparse {index, sign} update format the reference's
gradient-sharing mesh ships between workers, with residual accumulation in
``EncodedGradientsAccumulator``. Host code on numpy arrays: the same
encoded arrays as the JAX package's codecs for the same input. The port's
data-parallel step reduces dense gradients over the data group instead;
these codecs exist for API parity and for a bandwidth-starved link between
hosts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def threshold_encode(grad: np.ndarray, threshold: float) -> np.ndarray:
    """Sparse {signed index} encoding: int32 array [n, idx0±, idx1±, ...]
    where sign of entry encodes update direction and magnitude==threshold.
    Mirrors libnd4j's threshold format (header + signed indices)."""
    flat = np.asarray(grad).reshape(-1)
    idx = np.nonzero(np.abs(flat) >= threshold)[0]
    signs = np.sign(flat[idx]).astype(np.int32)
    # index+1 so sign survives index 0
    encoded = ((idx.astype(np.int64) + 1) * signs).astype(np.int64)
    return np.concatenate([[flat.size], encoded]).astype(np.int64)


def threshold_decode(encoded: np.ndarray, threshold: float) -> np.ndarray:
    size = int(encoded[0])
    out = np.zeros(size, np.float32)
    body = encoded[1:]
    idx = np.abs(body) - 1
    out[idx] = np.sign(body) * threshold
    return out


def threshold_residual(grad: np.ndarray, threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """encode + residual (grad - decoded), the accumulator loop of C7."""
    enc = threshold_encode(grad, threshold)
    dec = threshold_decode(enc, threshold).reshape(np.shape(grad))
    return enc, np.asarray(grad, np.float32) - dec


def bitmap_encode(grad: np.ndarray, threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Dense 2-bit-per-element encoding (libnd4j encodeBitmap): 0 = |g|<t,
    1 = +t, 2 = -t. Wins over threshold encoding when >~1/16 of entries
    exceed the threshold."""
    flat = np.asarray(grad).reshape(-1)
    codes = np.zeros(flat.size, np.uint8)
    codes[flat >= threshold] = 1
    codes[flat <= -threshold] = 2
    packed = np.packbits(np.unpackbits(codes.reshape(-1, 1), axis=1, count=2, bitorder="little"),
                         bitorder="little")
    return packed, np.asarray([flat.size], np.int64)


def bitmap_decode(packed: np.ndarray, size_arr: np.ndarray, threshold: float) -> np.ndarray:
    size = int(size_arr[0])
    bits = np.unpackbits(packed, bitorder="little")[: size * 2]
    codes = bits.reshape(-1, 2)
    vals = codes[:, 0].astype(np.float32) * threshold - codes[:, 1].astype(np.float32) * threshold
    return vals


class EncodedGradientsAccumulator:
    """The C7 accumulator loop: per step, each worker (1) adds its residual
    to the fresh gradient, (2) threshold-encodes it and keeps the new
    residual, (3) ships the encoded blob over a host ``Collectives``
    transport, (4) decodes every worker's blob and sums them: the same
    sparse update on every worker, so replicas stay in sync.

    Reference: ``org.deeplearning4j.optimize.solvers.accumulation.
    EncodedGradientsAccumulator``; here the transport is the Collectives
    SPI (``FakeCollectives`` in tests, ``launcher.ProcessCollectives``
    between processes)."""

    def __init__(self, collectives, threshold: float = 1e-3,
                 algorithm: "AdaptiveThresholdAlgorithm" = None):
        self.col = collectives
        self.threshold = threshold
        self.algorithm = algorithm
        self.residual: np.ndarray = None
        self.step = 0

    def exchange(self, grad: np.ndarray) -> np.ndarray:
        """One gradient exchange round; returns the summed sparse update
        (same array on every worker). ``grad`` is flattened internally."""
        flat = np.asarray(grad, np.float32).reshape(-1)
        if self.residual is None:
            self.residual = np.zeros_like(flat)
        carried = flat + self.residual
        thr = self.algorithm.update(carried) if self.algorithm else self.threshold
        enc, self.residual = threshold_residual(carried, thr)
        # each worker may run a different adaptive threshold: ship it with
        # the blob so decode uses the SENDER's threshold
        blobs = self.col.allgather(f"encgrad-{self.step}", (float(thr), enc))
        self.step += 1
        total = np.zeros_like(flat)
        for w_thr, w_enc in blobs:
            total += threshold_decode(np.asarray(w_enc), w_thr)
        return total.reshape(np.shape(grad))


class AdaptiveThresholdAlgorithm:
    """org.deeplearning4j...encoding.ThresholdAlgorithm (adaptive variant):
    adjust threshold toward a target update sparsity."""

    def __init__(self, initial: float = 1e-3, target_sparsity: float = 1e-3,
                 decay: float = 1.05):
        self.threshold = initial
        self.target = target_sparsity
        self.decay = decay

    def update(self, grad: np.ndarray) -> float:
        flat = np.asarray(grad).reshape(-1)
        sparsity = np.mean(np.abs(flat) >= self.threshold)
        if sparsity > self.target * 2:
            self.threshold *= self.decay
        elif sparsity < self.target / 2:
            self.threshold /= self.decay
        return self.threshold
