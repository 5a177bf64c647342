"""Port-local operations (counterparts of ``deeplearning4j_tpu.ops``): the
op registry (``registry``), filled on import by ``standard``, ``extended``,
``longtail``, ``tranche4``, ``tranche5`` and ``tranche6`` in the
reference's order, so a name a later module registers again ends bound as
in the reference; and ``transforms``, the eager ``Transforms`` over the
port's NDArray, imported last as the reference imports it."""
from deeplearning4j_tpu_torch.ops import registry  # noqa: F401
from deeplearning4j_tpu_torch.ops import standard  # noqa: F401 (registers)
from deeplearning4j_tpu_torch.ops import extended  # noqa: F401
from deeplearning4j_tpu_torch.ops import longtail  # noqa: F401
from deeplearning4j_tpu_torch.ops import tranche4  # noqa: F401
from deeplearning4j_tpu_torch.ops import tranche5  # noqa: F401
from deeplearning4j_tpu_torch.ops import tranche6  # noqa: F401
from deeplearning4j_tpu_torch.ops import transforms  # noqa: F401
