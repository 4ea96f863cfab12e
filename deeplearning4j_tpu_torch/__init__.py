"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: each module here keeps
the name and the semantics of its JAX counterpart, and the tests hold the
two against each other on the same weights and inputs. This package
imports ``torch`` and numpy only — never ``jax`` and nothing of the JAX
package.

Ported so far (the serving path of the flagship BERT-base transformer):

- ``kernels.attention`` — dense reference attention, and flash attention
  whose forward is a hand-written CUDA kernel (``csrc/flash_fwd.cu``) on
  CUDA tensors and its plain PyTorch version on CPU tensors;
- ``models.transformer`` — the encoder forward (``forward``, ``encode``,
  ``qa_forward``) and greedy generation (``prefill_forward``,
  ``DecodeSlotPool``, ``generate``);
- ``models.weights`` — the bridge from the JAX parameter pytree.

Entry points that place tensors take ``device`` and default to ``"cuda"``;
the CPU is used only when asked for (``device="cpu"``).
"""

from .common.device import resolve_device, set_fp32_numerics

__all__ = ["resolve_device", "set_fp32_numerics"]
