"""Parallelism of the port: training over processes, one device each, on a
mesh of ranks with named axes (``mesh``, ``collectives``, ``launcher``,
``trainer``, ``wrapper``, ``compression``): data-parallel, sharded
(FSDP x TP layouts in ``partition``, tensor-parallel rules in
``sharding``; sequence parallelism is ``kernels.attention``'s ring and
Ulysses attention) and pipelined (GPipe and 1F1B over a ``pipe`` axis,
``pipeline``); gangs of ranks supervised, restarted and elastically resized
(``supervisor``); and batched inference on one card (``inference``).

The package's names load lazily (PEP 562): a serving router that imports
``parallel.inference`` does not pay for importing torch."""

from importlib import import_module

_EXPORTS = {
    "MeshSpec": "mesh", "Mesh": "mesh", "build_mesh": "mesh", "device_count": "mesh",
    "mesh_from_shape": "mesh", "data_parallel_mesh": "mesh", "tp_dp_mesh": "mesh",
    "use_mesh": "mesh", "SpecLayout": "partition", "Partitioner": "partition",
    "PartitionReport": "partition", "largest_layout": "partition",
    "PipelinePartitioner": "partition", "PipelineParallelTrainer": "pipeline",
    "spmd_pipeline": "pipeline",
    "ShardingRules": "sharding", "alternating_dense_rules": "sharding",
    "PartitionSpec": "sharding",
    "ParallelTrainer": "trainer", "MultiProcessTrainer": "trainer",
    "ParameterAveragingTrainingMaster": "trainer", "SharedTrainingMaster": "trainer",
    "ParallelWrapper": "wrapper", "ParallelInference": "inference",
    "GangSupervisor": "supervisor", "GangFailedError": "supervisor",
    "GangEvent": "supervisor",
}
_SUBMODULES = ("collectives", "compression", "launcher", "mesh", "trainer", "wrapper",
               "inference", "partition", "sharding", "pipeline", "supervisor")

__all__ = sorted(_EXPORTS) + ["collectives", "compression", "launcher", "partition",
                              "sharding", "pipeline", "supervisor"]


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
    if name in _SUBMODULES:
        return import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
