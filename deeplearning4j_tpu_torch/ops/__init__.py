"""Port-local operations (counterparts of ``deeplearning4j_tpu.ops``): the
op registry (``registry``), filled on import by ``standard``, as the
reference's package fills its registry."""
from deeplearning4j_tpu_torch.ops import registry  # noqa: F401
from deeplearning4j_tpu_torch.ops import standard  # noqa: F401 (registers)
