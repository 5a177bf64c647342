"""Local TransformProcess executor
(ref: org.datavec.local.transforms.LocalTransformExecutor, SURVEY E3).

The reference's Spark/local executors exist to scale row-wise transforms;
here the transform core is already a pure fold over rows, so "local
execution" is the fold itself (optionally over a thread pool for large
inputs — kept simple since ETL runs on the host, not the card).
"""
from __future__ import annotations

from typing import List, Sequence

from deeplearning4j_tpu_torch.datavec.transform import TransformProcess
from deeplearning4j_tpu_torch.datavec.writable import unbox


class LocalTransformExecutor:
    @staticmethod
    def execute(input_data: Sequence, transform_process: TransformProcess) -> List:
        """Apply the process to a list of rows (ref: #execute)."""
        return transform_process.execute(list(input_data))

    @staticmethod
    def execute_to_values(input_data, transform_process) -> List[List]:
        """Same, unboxing Writables to plain Python values."""
        return [[unbox(v) for v in row]
                for row in transform_process.execute(list(input_data))]

    executeToValues = execute_to_values
