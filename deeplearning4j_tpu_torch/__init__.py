"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: each module here keeps
the name and the semantics of its JAX counterpart, and the tests hold the
two against each other on the same weights and inputs. This package
imports ``torch`` and numpy only — never ``jax`` and nothing of the JAX
package.

Ported so far (serving and training of the flagship BERT-base transformer, and
the runtime plumbing the next slices need):

- ``kernels.attention`` — dense reference attention, and differentiable
  flash attention whose forward and two backward passes are hand-written
  CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) on CUDA
  tensors and their plain PyTorch versions on CPU tensors;
- ``models.transformer`` — the encoder forward (``forward``, ``encode``,
  ``qa_forward``), greedy generation (``prefill_forward``,
  ``DecodeSlotPool``, ``generate``), and training (dropout,
  ``loss_fn``, ``qa_loss_fn``, ``make_train_step``, ``make_qa_train_step``,
  per-block remat) with its cost table ``layer_costs``;
- ``models.paged_decode`` — the block-paged KV cache with copy-on-write
  prefix sharing and speculative decoding (``PagedDecodeSlotPool``,
  ``generate``'s default pool), its decode step replayed as one CUDA graph;
- ``kernels.autotune`` — the flash forward's q-tile table: measured
  winners per card in ``autotune_cuda.json``, else the static H100 table;
- ``nn.updaters`` — all ten updaters and all seven schedules;
- ``common.environment``, ``common.dtypes``, ``common.precision`` — the
  ``TDL_*`` flags, nd4j's dtypes and promotion, the precision policy;
- ``models.weights`` — the bridge from the JAX parameter and updater-state
  pytrees;
- ``nn``, ``data``, ``eval`` and ``models.zoo``/``resnet``/``facenet``/
  ``text_lstm`` — MultiLayerNetwork and ComputationGraph with their layers,
  vertices, iterators and zoo models;
- ``serving`` — ``JsonModelServer`` and ``JsonModelClient`` over the
  micro-batching and the continuous-batching (generative) executors, the
  trace-replay ``LoadGenerator``, and ``ServingPool`` with its
  ``PoolAutoscaler``; ``parallel.inference`` — one-device
  ``ParallelInference``;
- ``monitoring`` — the metrics registry (the port's own), spools and their
  merge, the flight recorder, history ring, fleet timeline, heartbeats and
  alert rules; ``common.faults`` (``TDL_FAULT_SPEC``) and
  ``common.compile_cache`` (``TDL_COMPILE_CACHE_DIR``: the shared kernel
  build);
- ``serde`` — checkpoints in the JAX package's on-disk formats: the
  ``TrainingCheckpointer`` lineage with ``verify_checkpoint`` and
  ``PreemptionHandler``, and ``ModelSerializer``'s zip; ``listeners`` and
  ``nn.earlystopping`` on top of them; sharded lineages with a layout stamp
  and ``reshard=True``;
- ``parallel`` — the mesh of ranks with named axes, collectives over them,
  the launcher, data-parallel trainers, and sharded training: FSDP×TP
  layouts (``partition``), tensor-parallel rules (``sharding``), and the
  flagship on a (dp, tp, sp) mesh with ring or Ulysses attention; pipeline
  parallelism (``pipeline``: GPipe and 1F1B over a ``pipe`` axis,
  ``PipelineParallelTrainer``) with its cost partitioner
  (``monitoring.costmodel``);
- ``nlp`` — tokenizers and WordPiece, the vocabulary and Huffman codes,
  ``Word2Vec`` (its tables' rows optionally in blocks over a mesh axis),
  ``SequenceVectors``, ``ParagraphVectors``, ``Glove``, tf-idf, t-SNE and
  ``BertIterator``.

Entry points that place tensors take ``device`` and default to ``"cuda"``;
the CPU is used only when asked for (``device="cpu"``).
"""

__all__ = ["resolve_device", "set_fp32_numerics"]


def __getattr__(name):
    # lazy (PEP 562): a process that imports only the host-side modules (a
    # serving pool's router, a replica serving a numpy model) does not pay
    # for importing torch
    if name in __all__:
        from .common import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
