"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: each module here keeps
the name and the semantics of its JAX counterpart, and the tests hold the
two against each other on the same weights and inputs. This package
imports ``torch`` and numpy only — never ``jax`` and nothing of the JAX
package.

Ported so far (serving and training of the flagship BERT-base transformer):

- ``kernels.attention`` — dense reference attention, and differentiable
  flash attention whose forward and two backward passes are hand-written
  CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) on CUDA
  tensors and their plain PyTorch versions on CPU tensors;
- ``models.transformer`` — the encoder forward (``forward``, ``encode``,
  ``qa_forward``), greedy generation (``prefill_forward``,
  ``DecodeSlotPool``, ``generate``), and training (dropout,
  ``loss_fn``, ``qa_loss_fn``, ``make_train_step``, ``make_qa_train_step``);
- ``nn.updaters`` — ``Adam``, ``Sgd``, ``NoOp`` and two schedules;
- ``models.weights`` — the bridge from the JAX parameter and updater-state
  pytrees.

Entry points that place tensors take ``device`` and default to ``"cuda"``;
the CPU is used only when asked for (``device="cpu"``).
"""

from .common.device import resolve_device, set_fp32_numerics

__all__ = ["resolve_device", "set_fp32_numerics"]
