"""Power-of-two shape buckets and pad-to-bucket for the fit paths (copy of
the JAX package's ``common/bucketing.py``).

One bucket policy for the whole port: the decode pool pads each prompt to a
bucket, and the MLN and ComputationGraph fit paths (``set_bucketing``) pad
a ragged batch's rows, and optionally a recurrent batch's time steps, to
one. The port's eager step compiles nothing per shape, so a bucket buys it
what it buys the JAX package only where a shape is cached: the cuDNN plans
of ``cudnn.benchmark`` and a CUDA graph. It is kept for parity: the same
batches train the same way in both packages.

Correctness contract: padding must be invisible to the training math.
``pad_dataset`` pairs padded rows and time steps with zeroed mask entries,
and the loss layer's masked mean (``sum(per_unit * m) / sum(m)``) divides
by the TRUE example count, so a batch of 17 padded to 32 gives the loss and
gradients of the unpadded batch (within 1e-6, as the JAX package pins
them). Fit loops that pad report the true count as ``last_batch_size``.

The one construct the mask cannot protect is BatchNormalization: its batch
statistics run over every row of the padded batch, so ``set_bucketing``
refuses networks with BN layers.

Host arrays pad with numpy, tensors (a batch a ``DevicePrefetchIterator``
staged on the card) with torch on their own device: padding a staged batch
never copies it back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def bucket_size(n: int, *, min_bucket: int = 1, multiple: int = 1) -> int:
    """Smallest power-of-2 multiple of ``multiple`` that is >= ``n``, seeded
    at ``min_bucket`` so tiny inputs share one bucket."""
    if n < 0:
        raise ValueError(f"bucket_size needs n >= 0, got {n}")
    b = max(1, multiple)
    while b < min_bucket:
        b *= 2
    while b < n:
        b *= 2
    return b


def bucket_ladder(max_n: int, *, min_bucket: int = 1,
                  multiple: int = 1) -> List[int]:
    """Every bucket the policy can produce up to ``bucket_size(max_n)``,
    smallest first."""
    top = bucket_size(max_n, min_bucket=min_bucket, multiple=multiple)
    b = bucket_size(1, min_bucket=min_bucket, multiple=multiple)
    ladder = [b]
    while b < top:
        b *= 2
        ladder.append(b)
    return ladder


@dataclass(frozen=True)
class BucketSpec:
    """Pad-to-bucket policy for the training and eval fit paths.

    - ``batch``: pad the leading (example) dim of every features/labels
      array to ``bucket_size(B, min_bucket=min_batch, multiple=
      batch_multiple)``. ``batch_multiple`` is the data group's size on the
      parallel trainers (a bucket that keeps the remainder path dead).
    - ``sequence``: also pad the trailing time dim of rank-3 recurrent
      batches ([B, C, T]) to ``bucket_size(T, min_bucket=min_seq)``. Needs a
      ``labels_mask`` when labels are time-distributed: inventing one would
      change the loss from a per-example to a per-time-step mean, so that
      case raises.
    """

    batch: bool = True
    sequence: bool = False
    min_batch: int = 1
    batch_multiple: int = 1
    min_seq: int = 1

    def batch_bucket(self, n: int) -> int:
        return bucket_size(n, min_bucket=self.min_batch,
                           multiple=self.batch_multiple)

    def seq_bucket(self, t: int) -> int:
        return bucket_size(t, min_bucket=self.min_seq)


def _pad_rows_counter():
    from ..monitoring.registry import get_registry

    return get_registry().counter(
        "tdl_bucket_pad_rows_total",
        "Phantom rows added by pad-to-bucket in the fit paths — high "
        "relative to real rows means the bucket floor is too coarse",
        labels=("path",))


def _is_tensor(a) -> bool:
    # a tensor only exists where torch was imported; the check imports
    # nothing, so host-only users of this module never load torch
    torch = __import__("sys").modules.get("torch")
    return torch is not None and isinstance(a, torch.Tensor)


def _pad_axis(a, axis: int, pad: int):
    if a is None or pad == 0:
        return a
    if _is_tensor(a):
        import torch.nn.functional as F

        widths = [0, 0] * a.dim()
        widths[2 * (a.dim() - 1 - axis) + 1] = pad  # F.pad lists the last dim first
        return F.pad(a, widths)
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


def _ones_like_mask(a, shape):
    if _is_tensor(a):
        import torch

        return torch.ones(shape, dtype=torch.float32, device=a.device)
    return np.ones(shape, dtype=np.float32)


def pad_batch_dim(arr, bucket: int):
    """Pad ``arr``'s leading dim with zero rows up to ``bucket``."""
    if arr is None:
        return None
    n = int(arr.shape[0])
    return _pad_axis(arr, 0, bucket - n)


def pad_dataset(ds, spec: BucketSpec):
    """Pad one DataSet to its (batch, sequence) buckets, masking the
    padding out of the loss. Returns ``(padded_ds, true_examples)``.

    Padded rows get ``labels_mask = 0`` (a per-example [B] mask is created
    when the dataset had none); padded time steps extend an existing [B, T]
    mask with zeros. A bucket-aligned batch still gets the all-ones masks
    padding would have created, so aligned and padded batches take the same
    path through the loss.
    """
    from ..data.dataset import DataSet

    features = ds.features
    labels = ds.labels
    fmask = ds.features_mask
    lmask = ds.labels_mask
    n = int(features.shape[0])
    target_b = spec.batch_bucket(n) if spec.batch else n
    pad_b = target_b - n

    t = int(features.shape[-1]) if features.ndim == 3 else None
    seq_active = spec.sequence and t is not None
    target_t = spec.seq_bucket(t) if seq_active else t
    pad_t = (target_t - t) if t is not None else 0
    labels_time_distributed = labels is not None and labels.ndim == 3

    changed = False
    if spec.batch and lmask is None and not (labels_time_distributed and pad_t):
        # per-example [B] mask: ones for real rows, zeros for padding (the
        # tbptt path broadcasts it to its per-time-step [B, T] form)
        lmask = _ones_like_mask(labels if labels is not None else features, (n,))
        changed = True

    if seq_active:
        if labels_time_distributed and ds.labels_mask is None and pad_t:
            raise ValueError(
                "sequence bucketing needs a labels_mask when labels are "
                "time-distributed — inventing one would change the loss "
                "from a per-example to a per-timestep mean (no parity "
                "with unbucketed training); provide the mask or use "
                "BucketSpec(sequence=False)")
        # padded time steps must be invisible to time-aware reductions
        # (LastTimeStep, GlobalPooling read fmask)
        if fmask is None:
            fmask = _ones_like_mask(features, (n, t))
            changed = True

    if pad_t:
        fmask = _pad_axis(fmask, 1, pad_t)
        features = _pad_axis(features, features.ndim - 1, pad_t)
        if labels_time_distributed:
            labels = _pad_axis(labels, labels.ndim - 1, pad_t)
            lmask = _pad_axis(lmask, 1, pad_t)
        changed = True

    if pad_b:
        features = pad_batch_dim(features, target_b)
        labels = pad_batch_dim(labels, target_b)
        lmask = pad_batch_dim(lmask, target_b)
        fmask = pad_batch_dim(fmask, target_b) if fmask is not None else None
        _pad_rows_counter().labels("train").inc(pad_b)
        changed = True

    if not changed:
        return ds, n
    return DataSet(features, labels, fmask, lmask), n


def pad_multidataset(ds, spec: BucketSpec):
    """Batch-dim bucketing of a MultiDataSet (multi-input/output graphs):
    every features/labels array pads on its leading dim, every output gets
    a per-example mask with zeros on the padded rows. Returns
    ``(padded_mds, true_examples)``; as ``pad_dataset``, an aligned batch
    still gets its all-ones masks."""
    from ..data.dataset import MultiDataSet

    feats = list(ds.features)
    n = int(feats[0].shape[0])
    if not spec.batch:
        return ds, n
    target_b = spec.batch_bucket(n)
    labels = list(ds.labels)
    lmasks = list(ds.labels_masks) if getattr(ds, "labels_masks", None) else \
        [None] * len(labels)
    if target_b == n and all(m is not None for m in lmasks):
        return ds, n
    fmasks = (list(ds.features_masks)
              if getattr(ds, "features_masks", None) else None)
    out_masks = []
    for y, m in zip(labels, lmasks):
        if m is None:
            m = _ones_like_mask(y, (n,))
        out_masks.append(pad_batch_dim(m, target_b))
    if target_b > n:
        _pad_rows_counter().labels("train").inc(target_b - n)
    return MultiDataSet(
        [pad_batch_dim(f, target_b) for f in feats],
        [pad_batch_dim(y, target_b) for y in labels],
        features_masks=(None if fmasks is None else
                        [pad_batch_dim(m, target_b) for m in fmasks]),
        labels_masks=out_masks,
    ), n
