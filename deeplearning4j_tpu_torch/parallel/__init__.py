"""Parallelism of the port: batched inference on one card. The JAX
package's meshes, trainers, gangs and pipelines are ROADMAP item 6."""

from .inference import ParallelInference

__all__ = ["ParallelInference"]
