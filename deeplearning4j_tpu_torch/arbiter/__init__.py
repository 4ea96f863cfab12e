"""Hyperparameter optimization (DL4J's arbiter), counterpart of the JAX
package's ``arbiter``, with its public names.

``arbiter-core`` + ``arbiter-deeplearning4j``: a ``ParameterSpace`` tree
with leaf spaces (continuous/integer/discrete), candidate generators
(random / grid / genetic), ``LocalOptimizationRunner`` (score functions,
termination conditions, result tracking), and ``MultiLayerSpace`` mirroring
the network builders with spaces at every hyperparameter.

Beyond DL4J, ``fleet`` is the fault-isolated PBT/ASHA trial-fleet
meta-supervisor: concurrent trial gangs on the card, rung-based early
stopping, checkpoint-cloning exploit/explore and a durable sweep journal;
``trial_worker`` is the gangs' target.
"""

from .fleet import (
    GangTrialRunner,
    TrialFleet,
    TrialRunFailed,
    TrialSlot,
    TrialStraggler,
    spooled_scores,
)
from .optimize import (
    CandidateGenerator,
    ContinuousParameterSpace,
    DiscreteParameterSpace,
    GeneratorExhausted,
    GeneticSearchCandidateGenerator,
    GridSearchCandidateGenerator,
    IntegerParameterSpace,
    LocalOptimizationRunner,
    MaxCandidatesCondition,
    MaxTimeCondition,
    OptimizationResult,
    ParameterSpace,
    RandomSearchGenerator,
)
from .spaces import MultiLayerSpace

__all__ = [
    "ParameterSpace",
    "ContinuousParameterSpace",
    "IntegerParameterSpace",
    "DiscreteParameterSpace",
    "CandidateGenerator",
    "RandomSearchGenerator",
    "GridSearchCandidateGenerator",
    "GeneticSearchCandidateGenerator",
    "LocalOptimizationRunner",
    "OptimizationResult",
    "MaxCandidatesCondition",
    "MaxTimeCondition",
    "MultiLayerSpace",
    "GeneratorExhausted",
    "TrialFleet",
    "TrialSlot",
    "TrialStraggler",
    "TrialRunFailed",
    "GangTrialRunner",
    "spooled_scores",
]
