"""Device resolution and the float32 numerics policy of the port.

Every entry point that places tensors takes ``device`` and defaults to
``"cuda"``. The CPU runs only when the caller asks for it: on a host with no
GPU a call that leaves ``device`` at its default raises instead of running
quietly on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def has_values(t: torch.Tensor) -> bool:
    """False for a tensor that carries shapes only (a fake or meta tensor,
    as ``monitoring.costmodel`` counts a step's flops on): the host checks
    of id and segment values skip such a tensor, which has no values to
    check."""
    return not (t.is_meta or isinstance(t, torch._subclasses.fake_tensor.FakeTensor))


def set_fp32_numerics() -> None:
    """Run float32 matrix products and convolutions in full float32.

    PyTorch's default already keeps TF32 off for matrix products, but cuDNN
    convolutions use TF32 unless told otherwise; TF32 keeps about three
    decimal digits. Parity checks against the JAX reference, and the tied
    decoder of ``mlm_head`` (bf16 operands, exact float32 products), need
    both off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
