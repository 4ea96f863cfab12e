"""ParallelWrapper — data-parallel fit behind DL4J's builder API.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (DL4J's
``org.deeplearning4j.parallelism.ParallelWrapper``: a model replica per
device, periodic parameter averaging or gradient sharing). The port runs
one device per process, so ``workers`` are the ranks of the data group
(``parallel.launcher.launch`` starts them): the default is the group's
size, and a larger number raises, since the port has no single-process
multi-device mode. The fit is :class:`~.trainer.ParallelTrainer`'s (every
rank feeds the same global batches); ``training_mode="AVERAGING"`` with
``averaging_frequency > 1`` selects the in-process
:class:`~.trainer.ParameterAveragingTrainingMaster`, as in the JAX package.
``prefetch_buffer`` is kept for the API: batches are staged synchronously
(asynchronous staging is ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

from .mesh import build_mesh, device_count
from .trainer import ParallelTrainer, ParameterAveragingTrainingMaster


class ParallelWrapper:
    def __init__(self, model, workers: Optional[int] = None,
                 prefetch_buffer: int = 2, averaging_frequency: int = 1,
                 report_score_after_averaging: bool = True,
                 training_mode: str = "SHARED_GRADIENTS"):
        self.model = model
        self.workers = workers or device_count()
        self.prefetch_buffer = prefetch_buffer
        self.averaging_frequency = averaging_frequency
        self.training_mode = training_mode
        if training_mode != "AVERAGING" or averaging_frequency <= 1:
            if self.workers > device_count():
                raise ValueError(
                    f"workers={self.workers} but the data group has {device_count()} "
                    "process(es): the port runs one device per process, so start "
                    f"{self.workers} ranks with parallel.launcher.launch and build the "
                    "wrapper in each")

    def fit(self, iterator, epochs: int = 1):
        if self.training_mode == "AVERAGING" and self.averaging_frequency > 1:
            master = ParameterAveragingTrainingMaster(
                workers=self.workers, averaging_frequency=self.averaging_frequency)
            return master.fit(self.model, iterator, epochs)
        trainer = ParallelTrainer(self.model, mesh=build_mesh(data=self.workers))
        return trainer.fit(iterator, epochs)

    def shutdown(self):
        return None

    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def workers(self, n: int):
            self._kw["workers"] = n
            return self

        def prefetch_buffer(self, n: int):
            self._kw["prefetch_buffer"] = n
            return self

        prefetchBuffer = prefetch_buffer

        def averaging_frequency(self, n: int):
            self._kw["averaging_frequency"] = n
            return self

        averagingFrequency = averaging_frequency

        def training_mode(self, mode: str):
            self._kw["training_mode"] = mode
            return self

        trainingMode = training_mode

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._model, **self._kw)
