"""Model serving: production-hardened JSON HTTP inference (the port of the
JAX package's ``serving``).

Reference: ``deeplearning4j-remote`` / ``nd4j-remote`` ``JsonModelServer``:
an HTTP endpoint wrapping a MultiLayerNetwork or ComputationGraph (and
ParallelInference for batching) with typed (de)serializers.

Layered as: ``JsonModelServer`` (HTTP, admission control, deadlines,
liveness/readiness, graceful drain) over ``BatchingInferenceExecutor``
(bounded queue, micro-batching, warmup, chaos hooks) over
``parallel.ParallelInference`` (bucketed padded batches on one card), or
over ``GenerativeInferenceExecutor`` (continuous batching) and a decode slot
pool; ``ServingPool`` runs replica processes behind one router, and
``LoadGenerator`` replays traffic against any of them.
"""

from .executor import (BatchingInferenceExecutor, DeadlineExceededError,
                       ExecutorClosedError, GenerationFuture,
                       GenerativeInferenceExecutor, InferenceFuture,
                       QueueFullError)
from .json_server import JsonModelServer, JsonModelClient
from .loadgen import Burst, LoadGenerator, TraceSpec, replay
from .pool import PoolAutoscaler, ServingPool

__all__ = [
    "JsonModelServer",
    "JsonModelClient",
    "BatchingInferenceExecutor",
    "GenerativeInferenceExecutor",
    "GenerationFuture",
    "InferenceFuture",
    "QueueFullError",
    "DeadlineExceededError",
    "ExecutorClosedError",
    "Burst",
    "LoadGenerator",
    "TraceSpec",
    "replay",
    "ServingPool",
    "PoolAutoscaler",
]
