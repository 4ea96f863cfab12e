"""Parallelism of the port: data-parallel training over processes, one
device each (``mesh``, ``trainer``, ``wrapper``, ``launcher``,
``collectives``, ``compression``), and batched inference on one card
(``inference``). The JAX package's sharded training (FSDP x TP layouts,
tensor-parallel rules, pipelines, sequence parallelism) and its gang
supervisor are the next slice (ROADMAP.md item 6).

The package's names load lazily (PEP 562): a serving router that imports
``parallel.inference`` does not pay for importing torch."""

from importlib import import_module

_EXPORTS = {
    "MeshSpec": "mesh", "build_mesh": "mesh", "device_count": "mesh",
    "mesh_from_shape": "mesh", "data_parallel_mesh": "mesh",
    "ParallelTrainer": "trainer", "MultiProcessTrainer": "trainer",
    "ParameterAveragingTrainingMaster": "trainer", "SharedTrainingMaster": "trainer",
    "ParallelWrapper": "wrapper", "ParallelInference": "inference",
}
_SUBMODULES = ("collectives", "compression", "launcher", "mesh", "trainer", "wrapper",
               "inference")

__all__ = sorted(_EXPORTS) + ["collectives", "compression", "launcher"]


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
    if name in _SUBMODULES:
        return import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
