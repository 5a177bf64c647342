"""Partitioned TransformProcess execution — the Spark-engine analog
(ref: ``datavec/datavec-spark`` ``SparkTransformExecutor`` — SURVEY E3).

The reference distributes ETL over Spark RDD partitions. The port has no
cluster scheduler dependency (SURVEY §7: "keep a
Spark-compatible data-ingest shim only if required"); the equivalent at
single-host scale is partitioned execution over a process pool — the same
partition → map → collect contract, minus the cluster. Workers inherit the
TransformProcess by fork (its steps are closures, the in-process analog of
Spark shipping the serialized pipeline to executors); platforms without
fork fall back to in-process execution.
"""
from __future__ import annotations

import multiprocessing as mp
import threading
from typing import List, Sequence

from deeplearning4j_tpu_torch.datavec.transform import TransformProcess

# fork-inherited state. TransformProcess steps are closures (unpicklable),
# so they reach workers only via fork inheritance of this global; the lock
# serializes concurrent execute() calls so one call's pool can never fork
# while another call's TransformProcess is installed.
_WORKER_TP = None
_EXEC_LOCK = threading.Lock()


def _run_partition(rows):
    return _WORKER_TP.execute(list(rows))


class ParallelTransformExecutor:
    """Partitioned executor (ref API shape: SparkTransformExecutor#execute
    over an RDD; here partitions → forked worker processes)."""

    @staticmethod
    def execute(input_data: Sequence, transform_process: TransformProcess,
                num_partitions: int = 4) -> List:
        global _WORKER_TP
        rows = list(input_data)
        if not rows or num_partitions <= 1:
            return transform_process.execute(rows)
        try:
            ctx = mp.get_context("fork")
        except ValueError:              # no fork (e.g. non-POSIX)
            return transform_process.execute(rows)
        num_partitions = min(num_partitions, len(rows))
        chunk = -(-len(rows) // num_partitions)
        parts = [rows[i:i + chunk] for i in range(0, len(rows), chunk)]
        with _EXEC_LOCK:
            _WORKER_TP = transform_process
            try:
                with ctx.Pool(processes=len(parts)) as pool:
                    results = pool.map(_run_partition, parts)
            finally:
                _WORKER_TP = None
        out = []
        for r in results:
            out.extend(r)
        return out
