"""Schema: typed column metadata for TransformProcess
(ref: org.datavec.api.transform.schema.Schema + ColumnType, SURVEY E1).
"""
from __future__ import annotations

from typing import List, Optional, Sequence


class ColumnType:
    Integer = "Integer"
    Long = "Long"
    Double = "Double"
    Float = "Float"
    Categorical = "Categorical"
    String = "String"
    Boolean = "Boolean"
    Time = "Time"
    NDArray = "NDArray"


class ColumnMetaData:
    def __init__(self, name: str, column_type: str,
                 state_names: Optional[Sequence[str]] = None):
        self.name = name
        self.column_type = column_type
        self.state_names = list(state_names) if state_names else None

    def __repr__(self):
        return f"ColumnMetaData({self.name!r}, {self.column_type})"


class Schema:
    """ref: transform.schema.Schema (+ .Builder)."""

    def __init__(self, columns: Sequence[ColumnMetaData] = ()):
        self.columns: List[ColumnMetaData] = list(columns)

    # ---- queries
    def get_column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    getColumnNames = get_column_names

    def num_columns(self) -> int:
        return len(self.columns)

    numColumns = num_columns

    def get_index_of_column(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"No column {name!r}; have {self.get_column_names()}")

    getIndexOfColumn = get_index_of_column

    def get_meta_data(self, name: str) -> ColumnMetaData:
        return self.columns[self.get_index_of_column(name)]

    getMetaData = get_meta_data

    def get_type(self, name: str) -> str:
        return self.get_meta_data(name).column_type

    def with_columns(self, columns) -> "Schema":
        return Schema(columns)

    def __repr__(self):
        rows = "\n".join(f"  {i}: {c.name} ({c.column_type})"
                         for i, c in enumerate(self.columns))
        return f"Schema [\n{rows}\n]"

    # ---- builder
    class Builder:
        def __init__(self):
            self._cols: List[ColumnMetaData] = []

        def add_column_integer(self, *names):
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Integer))
            return self

        addColumnInteger = add_column_integer
        addColumnsInteger = add_column_integer

        def add_column_long(self, *names):
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Long))
            return self

        addColumnLong = add_column_long

        def add_column_double(self, *names):
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Double))
            return self

        addColumnDouble = add_column_double
        addColumnsDouble = add_column_double

        def add_column_float(self, *names):
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Float))
            return self

        addColumnFloat = add_column_float

        def add_column_categorical(self, name, *state_names):
            states = (list(state_names[0]) if len(state_names) == 1
                      and isinstance(state_names[0], (list, tuple))
                      else list(state_names))
            self._cols.append(ColumnMetaData(name, ColumnType.Categorical,
                                             states))
            return self

        addColumnCategorical = add_column_categorical

        def add_column_string(self, *names):
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.String))
            return self

        addColumnString = add_column_string

        def add_column_boolean(self, *names):
            for n in names:
                self._cols.append(ColumnMetaData(n, ColumnType.Boolean))
            return self

        addColumnBoolean = add_column_boolean

        def add_column_time(self, name, tz=None):
            self._cols.append(ColumnMetaData(name, ColumnType.Time))
            return self

        addColumnTime = add_column_time

        def build(self) -> "Schema":
            return Schema(self._cols)
