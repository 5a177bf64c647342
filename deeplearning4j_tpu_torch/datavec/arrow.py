"""Arrow columnar bridge for DataVec (ref: ``datavec/datavec-arrow``
``org.datavec.arrow.ArrowConverter`` + ``recordreader.ArrowRecordReader`` —
SURVEY E3).

Converts between DataVec's row-of-Writables world and Arrow columnar
tables/IPC files (plus parquet, the modern interchange the reference's Arrow
module targets via the same memory format). Gated on ``pyarrow`` at call
time — the module imports cleanly without it.
"""
from __future__ import annotations

from typing import List, Sequence

from deeplearning4j_tpu_torch.datavec.records import RecordReader, _ListBackedReader
from deeplearning4j_tpu_torch.datavec.schema import ColumnMetaData, ColumnType, Schema
from deeplearning4j_tpu_torch.datavec.writable import (BooleanWritable,
                                                 DoubleWritable, IntWritable,
                                                 Text, Writable)


def _require_pyarrow():
    try:
        import pyarrow
        return pyarrow
    except ImportError as e:       # pragma: no cover - env-dependent
        raise ImportError(
            "pyarrow is required for the DataVec Arrow bridge") from e


_TO_ARROW = {
    ColumnType.Integer: "int64", ColumnType.Long: "int64",
    ColumnType.Double: "float64", ColumnType.Float: "float32",
    ColumnType.Boolean: "bool_",
    ColumnType.String: "string", ColumnType.Categorical: "string",
    ColumnType.Time: "int64",
}


class ArrowConverter:
    """ref API shape: ArrowConverter#toArrow / #toDatavec (+ file IO)."""

    # ------------------------------------------------------------- to arrow
    @staticmethod
    def to_arrow(schema: Schema, rows: Sequence[Sequence[Writable]]):
        """Rows of Writables → pyarrow.Table with a faithful typed schema."""
        pa = _require_pyarrow()
        cols = {}
        for i, meta in enumerate(schema.columns):
            vals = [r[i].value for r in rows]
            pa_type = getattr(pa, _TO_ARROW.get(meta.column_type, "string"))()
            cols[meta.name] = pa.array(vals, type=pa_type)
        return pa.table(cols)

    toArrow = to_arrow

    # ----------------------------------------------------------- to datavec
    @staticmethod
    def arrow_schema_to_datavec(table) -> Schema:
        import pyarrow as pa
        cols = []
        for field in table.schema:
            if pa.types.is_integer(field.type):
                ct = ColumnType.Integer
            elif pa.types.is_floating(field.type):
                ct = ColumnType.Double
            elif pa.types.is_boolean(field.type):
                ct = ColumnType.Boolean
            else:
                ct = ColumnType.String
            cols.append(ColumnMetaData(field.name, ct))
        return Schema(cols)

    @staticmethod
    def to_datavec(table) -> List[List[Writable]]:
        """pyarrow.Table → rows of typed Writables."""
        import pyarrow as pa
        out = []
        pydict = table.to_pydict()
        names = table.schema.names
        n = table.num_rows
        for r in range(n):
            row = []
            for name, field in zip(names, table.schema):
                v = pydict[name][r]
                if pa.types.is_integer(field.type):
                    row.append(IntWritable(int(v)))
                elif pa.types.is_floating(field.type):
                    row.append(DoubleWritable(float(v)))
                elif pa.types.is_boolean(field.type):
                    row.append(BooleanWritable(bool(v)))
                else:
                    row.append(Text(str(v)))
            out.append(row)
        return out

    toDatavec = to_datavec

    # --------------------------------------------------------------- file IO
    @staticmethod
    def write_ipc(schema: Schema, rows, path: str):
        pa = _require_pyarrow()
        import pyarrow.feather as feather
        feather.write_feather(ArrowConverter.to_arrow(schema, rows), path)

    @staticmethod
    def write_parquet(schema: Schema, rows, path: str):
        _require_pyarrow()
        import pyarrow.parquet as pq
        pq.write_table(ArrowConverter.to_arrow(schema, rows), path)


class ArrowRecordReader(_ListBackedReader):
    """Reads Arrow IPC/feather or parquet files into DataVec records (ref:
    org.datavec.arrow.recordreader.ArrowRecordReader)."""

    def __init__(self):
        super().__init__()
        self.schema: Schema = None

    def initialize(self, split):
        pa = _require_pyarrow()
        import pyarrow.feather as feather
        import pyarrow.parquet as pq
        self._rows = []
        for loc in split.locations():
            if str(loc).endswith((".parquet", ".pq")):
                table = pq.read_table(loc)
            else:
                table = feather.read_table(loc)
            if self.schema is None:
                self.schema = ArrowConverter.arrow_schema_to_datavec(table)
            self._rows.extend(ArrowConverter.to_datavec(table))
        self._pos = 0
        return self
