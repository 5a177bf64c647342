"""DataVec-equivalent ETL layer of the port: counterpart of
``deeplearning4j_tpu/datavec/`` (ref: datavec/ modules, SURVEY E1-E3).
Host code over numpy and the stdlib; ``PIL`` and ``pyarrow`` are imported
only inside the functions that need them.

Record readers produce lists of ``Writable`` values; ``TransformProcess``
applies schema-typed column transforms; ``LocalTransformExecutor`` runs them;
the image pipeline decodes/augments to NHWC arrays ready for the device.
"""
from deeplearning4j_tpu_torch.datavec.writable import (
    BooleanWritable, DoubleWritable, FloatWritable, IntWritable, LongWritable,
    NDArrayWritable, Text, Writable)
from deeplearning4j_tpu_torch.datavec.schema import Schema
from deeplearning4j_tpu_torch.datavec.transform import TransformProcess
from deeplearning4j_tpu_torch.datavec.records import (
    CollectionRecordReader, CSVRecordReader, CSVSequenceRecordReader,
    FileSplit, JacksonLineRecordReader, LineRecordReader, ListStringSplit,
    RecordReader, RegexLineRecordReader)
from deeplearning4j_tpu_torch.datavec.local import LocalTransformExecutor

__all__ = [
    "Writable", "IntWritable", "LongWritable", "FloatWritable",
    "DoubleWritable", "BooleanWritable", "Text", "NDArrayWritable",
    "Schema", "TransformProcess", "RecordReader", "CSVRecordReader",
    "RegexLineRecordReader", "JacksonLineRecordReader",
    "LineRecordReader", "CollectionRecordReader", "CSVSequenceRecordReader",
    "FileSplit", "ListStringSplit", "LocalTransformExecutor",
]
from deeplearning4j_tpu_torch.datavec.arrow import ArrowConverter, ArrowRecordReader  # noqa: E402

__all__ += ["ArrowConverter", "ArrowRecordReader"]
