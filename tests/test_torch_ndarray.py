"""The port's ND4J against the JAX package's: every case of
``tests/test_ndarray.py`` runs as written over both packages, on the same
seeded inputs, and the two runs are held to each other value for value
(``_torch_nd_twin``: f32 at atol = rtol = 1e-6, reductions and products
1e-5, ints, bools, dtypes and shapes exactly; random draws in
distribution). One case, ``TestInterop::test_jnp_consumes_ndarray``,
reads the buffer through JAX: the port's twin reads it through torch."""
import numpy as np
import pytest
import torch

import test_ndarray as REF_TESTS
from _torch_nd_twin import _port_on_cpu, cases, run_twin  # noqa: F401

from deeplearning4j_tpu_torch.ndarray import nd as PORT_ND

# the one case whose body names JAX: its port side is the torch reading
_JAX_BODY = {"TestInterop::test_jnp_consumes_ndarray"}
CASES = [c for c in cases(REF_TESTS) if c not in _JAX_BODY]


@pytest.mark.parametrize("case", CASES)
def test_twin(case, tmp_path):
    assert run_twin(REF_TESTS, case, tmp_path) > 0


def test_torch_consumes_ndarray():
    """The port's side of ``test_jnp_consumes_ndarray``: ``buf()`` is the
    tensor, which torch consumes as JAX consumes the reference's."""
    a = PORT_ND.ones(2, 2)
    assert isinstance(a.buf(), torch.Tensor)
    assert float(torch.sum(a.buf())) == 4.0
    assert float(np.sum(np.asarray(a))) == 4.0
