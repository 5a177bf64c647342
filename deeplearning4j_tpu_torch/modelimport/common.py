"""Shared importer helpers: counterpart of
``deeplearning4j_tpu/modelimport/common.py`` (ref: ``samediff-import-api``)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def fold_constant(sd, var) -> Optional[np.ndarray]:
    """Evaluate ``var`` if it depends only on constants; None otherwise."""
    try:
        fn = sd._emit([var.name])
        with torch.no_grad():
            return fn(sd._values, {}, 0)[0].detach().cpu().numpy()
    except Exception:
        return None
