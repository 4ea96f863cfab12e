"""Checkpoints and model files, in the JAX package's on-disk formats:
``checkpoint`` (the ``TrainingCheckpointer`` lineage, ``verify_checkpoint``,
``PreemptionHandler``), ``model_serializer`` (the ModelSerializer zip) and
``net_state`` (a network's state as the JAX package's trees). Importing this
package loads numpy only; torch comes with a save or a restore."""

from .checkpoint import (CheckpointVerifyError, PreemptionHandler, TrainingCheckpointer,
                         lineage_state, verify_checkpoint)
from .model_serializer import ModelGuesser, ModelSerializer

__all__ = ["CheckpointVerifyError", "ModelGuesser", "ModelSerializer", "PreemptionHandler",
           "TrainingCheckpointer", "lineage_state", "verify_checkpoint"]
