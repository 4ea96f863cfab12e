"""ParallelInference — batched inference on one device.

The counterpart of the JAX package's ``parallel.inference`` for one card:
requests are padded up to a power-of-two bucketed batch size
(``common.bucketing``, ``multiple=1``) so a few batch shapes serve every
concurrency level, and the model's ``output`` places the batch on the
model's device. The JAX version's mesh and replicated state have no
counterpart here: the port serves one device.

The helpers below are the one place that turns a model's output into what a
serving request gets back: a ``ComputationGraph`` answers with a list of its
network outputs, and a tensor may live on the card in bfloat16. They look
torch up in ``sys.modules`` instead of importing it: until some model has
imported torch no tensor and no grad mode exist, and a process that serves
a numpy model (a pool's router, a stub replica) starts without paying for
the import.
"""

from __future__ import annotations

import contextlib
import sys
from typing import List

import numpy as np

from ..common.bucketing import bucket_ladder, bucket_size


def check_single_output(model) -> None:
    """Refuse a model whose ``output`` answers with more than one array.

    A ``ComputationGraph`` returns one array per network output. Serving
    answers each request with ONE array, cut from the batch along its rows,
    so a graph with several outputs has no single answer to cut (the JAX
    executor stacks the list and cuts it along the list axis instead, which
    hands each request the wrong rows)."""
    outputs = getattr(getattr(model, "conf", None), "network_outputs", None)
    if outputs is not None and len(outputs) != 1:
        raise ValueError(
            f"cannot serve a ComputationGraph with {len(outputs)} network "
            f"outputs {list(outputs)}: a request gets one array, cut from the "
            "batch's rows; serve a graph with one network output")


def inference_mode():
    """``torch.inference_mode()`` once torch is imported, else nothing to
    switch off. Grad mode is per thread, and a serving thread starts with
    it on."""
    torch = sys.modules.get("torch")
    return torch.inference_mode() if torch is not None else contextlib.nullcontext()


def host_array(x) -> np.ndarray:
    """``x`` as a host numpy array: a tensor is detached and copied to the
    host, bfloat16 widened to float32 (numpy has no bfloat16; these are the
    values the JSON serializer would print)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def model_output(model, x) -> np.ndarray:
    """``model.output(x)`` as a host array, run under
    :func:`inference_mode`. A single-output graph's one-element list is
    unwrapped; see :func:`check_single_output` for graphs with more."""
    with inference_mode():
        out = model.output(x)
        if isinstance(out, (list, tuple)):
            if len(out) != 1:
                raise ValueError(f"model.output returned {len(out)} arrays; "
                                 "serving needs one")
            out = out[0]
        return host_array(out)


class ParallelInference:
    def __init__(self, model, batch_limit: int = 32):
        check_single_output(model)
        self.model = model
        self.batch_limit = batch_limit

    def _bucket(self, n: int) -> int:
        """Smallest power of two that fits n, seeded at ``batch_limit`` so
        tiny requests share one batch shape."""
        return bucket_size(n, min_bucket=self.batch_limit)

    def bucket_sizes(self, max_rows: int) -> List[int]:
        """Every bucket this instance can produce up to ``_bucket(max_rows)``,
        smallest first — the serving executor warms this ladder so the first
        large batch pays no first-shape cost mid-traffic."""
        return bucket_ladder(max_rows, min_bucket=self.batch_limit)

    def output(self, x) -> np.ndarray:
        """Pad to a bucketed batch size, run the forward, trim."""
        arr = host_array(x)
        n = arr.shape[0]
        bucket = self._bucket(n)
        if n < bucket:
            pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
            arr = np.concatenate([arr, pad], axis=0)
        return model_output(self.model, arr)[:n]

    def output_batched(self, xs: List[np.ndarray]) -> List[np.ndarray]:
        """Service a list of requests as one padded batch (request batching).

        Inputs are validated up front: an empty list returns ``[]``, and a
        mixed-dtype or mixed-feature-shape list raises a ``ValueError``
        naming the offending request index instead of failing deep inside
        the forward.
        """
        arrs = [host_array(x) for x in xs]
        if not arrs:
            return []
        for i, a in enumerate(arrs):
            if a.ndim == 0:
                raise ValueError(
                    f"request {i}: scalar input — every request needs a "
                    f"batch dimension")
        ref = arrs[0]
        for i, a in enumerate(arrs[1:], start=1):
            if a.shape[1:] != ref.shape[1:]:
                raise ValueError(
                    f"request {i}: feature shape {a.shape[1:]} does not "
                    f"match request 0's {ref.shape[1:]}")
            if a.dtype != ref.dtype:
                raise ValueError(
                    f"request {i}: dtype {a.dtype} does not match "
                    f"request 0's {ref.dtype}")
        sizes = [a.shape[0] for a in arrs]
        out = self.output(np.concatenate(arrs, axis=0))
        res, off = [], 0
        for s in sizes:
            res.append(out[off : off + s])
            off += s
        return res
