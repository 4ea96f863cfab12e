"""Mixed-precision policy (``TDL_MATMUL_PRECISION``).

Counterpart of ``deeplearning4j_tpu/common/precision.py``: master
parameters in float32, products and activations in the compute dtype the
policy names, losses and statistics in float32, gradients back in float32
through the entry casts.

Policy values (env ``TDL_MATMUL_PRECISION`` or ``env().set(...)``):

- ``auto`` (default): bf16 on an accelerator, float32 on the CPU. The JAX
  package asks its default backend; the port asks the device the work runs
  on, ``device`` (``"cuda"`` by default, as for every entry point):
  ``compute_dtype(device="cuda")`` is bf16 and ``compute_dtype(device="cpu")``
  is float32;
- ``bfloat16``/``bf16``: bf16 everywhere;
- ``float32``/``highest``: float32 everywhere;
- ``tf32``: float32, as in the JAX package. The policy does not flip
  ``torch.backends.cuda.matmul.allow_tf32``: a policy query that changed a
  process-wide switch would be a side effect the reference does not have
  (``common.device.set_fp32_numerics`` is the explicit switch).

Nothing on the flagship's path reads the policy: ``TransformerConfig``
states its ``compute_dtype`` (bf16 by default), as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from .device import DEFAULT_DEVICE
from .environment import env


def compute_dtype(device=DEFAULT_DEVICE) -> torch.dtype:
    """The activation and product dtype the current policy names for work
    on ``device``."""
    p = str(env().matmul_precision).lower()
    if p in ("bfloat16", "bf16"):
        return torch.bfloat16
    if p == "auto" and torch.device(device).type != "cpu":
        return torch.bfloat16
    return torch.float32


def amp_enabled(model_dtype=torch.float32, device=DEFAULT_DEVICE) -> bool:
    """AMP is on only for float32 models (an explicitly bf16 or float64
    model states its own policy)."""
    return compute_dtype(device) == torch.bfloat16 and model_dtype == torch.float32


def cast_floating(tree, dtype):
    """Every floating tensor of a (nested) dict, list or tuple cast to
    ``dtype``; integer and bool tensors and other leaves are left as they
    are. An ``nn.Module`` is taken for its ``named_parameters()`` and gives
    a {name: tensor} dict (the parameters themselves are not changed)."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def cast_input(x, dtype):
    """One (possibly None) array cast to ``dtype`` if it is floating; an
    integer or bool input is returned as it is."""
    if x is None:
        return None
    t = torch.as_tensor(x)
    return t.to(dtype) if t.is_floating_point() else x
