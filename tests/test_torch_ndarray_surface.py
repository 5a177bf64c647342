"""The port's INDArray/Nd4j surface tranches against the JAX package's:
every case of ``tests/test_ndarray_surface.py`` runs as written over both
packages and the two runs are held to each other (``_torch_nd_twin``:
f32 at atol = rtol = 1e-6, reductions and products 1e-5, ints, bools,
dtypes and shapes exactly)."""
import pytest

import test_ndarray_surface as REF_TESTS
from _torch_nd_twin import _port_on_cpu, cases, run_twin  # noqa: F401


@pytest.mark.parametrize("case", cases(REF_TESTS))
def test_twin(case, tmp_path):
    assert run_twin(REF_TESTS, case, tmp_path) > 0
