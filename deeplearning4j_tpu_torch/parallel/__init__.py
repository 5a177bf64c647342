"""Multi-device pieces of the port: data-parallel training over
``torch.distributed`` (``mesh``, ``trainer``, ``master``, ``compression``),
``ParallelInference`` and the MoE FFN.

Ring attention (``parallel/ring.py`` in the JAX package) is ROADMAP queue 1
item 7B and is not exported. ``parallel.generation`` is imported on its own
(``from deeplearning4j_tpu_torch.parallel.generation import
GenerationPipeline``), as in the reference.
"""
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS, MeshSpec)
from deeplearning4j_tpu_torch.parallel.trainer import (  # noqa: F401
    ParallelWrapper, ShardedTrainer)
from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    InferenceMode, ParallelInference)
from deeplearning4j_tpu_torch.parallel.master import (  # noqa: F401
    DistributedConfig, ParameterAveragingTrainingMaster, SharedTrainingMaster,
    SparkComputationGraph, SparkDl4jMultiLayer, TrainingMaster)
from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    AdaptiveThresholdAlgorithm, FixedThresholdAlgorithm, ThresholdAlgorithm)
