"""TransformProcess: schema-typed column transform pipelines
(ref: org.datavec.api.transform.TransformProcess + transform/condition/filter
op classes, SURVEY E1).

Each step is a pure function ``(schema, rows) -> (schema, rows)`` where a row
is a list of Writables; the executor (local.py) just folds the steps. This
keeps reference semantics (schema validated/evolved per step) while the
executor stays trivially parallelizable.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.datavec.schema import ColumnMetaData, ColumnType, Schema
from deeplearning4j_tpu_torch.datavec.writable import (
    BooleanWritable, DoubleWritable, IntWritable, Text, Writable, box, unbox)

Row = List[Writable]


# ------------------------------------------------------------- conditions
class Condition:
    """ref: transform.condition.Condition — predicate over a row."""

    def __init__(self, column: str, fn: Callable[[object], bool]):
        self.column = column
        self.fn = fn

    def matches(self, schema: Schema, row: Row) -> bool:
        return self.fn(unbox(row[schema.get_index_of_column(self.column)]))


class ConditionOp:
    """ref: transform.condition.ConditionOp enum."""

    @staticmethod
    def less_than(column, value):
        return Condition(column, lambda v: v < value)

    LessThan = less_than

    @staticmethod
    def greater_than(column, value):
        return Condition(column, lambda v: v > value)

    GreaterThan = greater_than

    @staticmethod
    def equals(column, value):
        return Condition(column, lambda v: v == value)

    Equal = equals

    @staticmethod
    def not_equals(column, value):
        return Condition(column, lambda v: v != value)

    @staticmethod
    def in_set(column, values):
        s = set(values)
        return Condition(column, lambda v: v in s)

    InSet = in_set


class MathOp:
    """ref: transform.MathOp enum."""
    Add = "Add"
    Subtract = "Subtract"
    Multiply = "Multiply"
    Divide = "Divide"
    Modulus = "Modulus"
    ReverseSubtract = "ReverseSubtract"
    ReverseDivide = "ReverseDivide"
    ScalarMin = "ScalarMin"
    ScalarMax = "ScalarMax"

    _FNS = {
        "Add": lambda v, s: v + s,
        "Subtract": lambda v, s: v - s,
        "Multiply": lambda v, s: v * s,
        "Divide": lambda v, s: v / s,
        "Modulus": lambda v, s: v % s,
        "ReverseSubtract": lambda v, s: s - v,
        "ReverseDivide": lambda v, s: s / v,
        "ScalarMin": lambda v, s: min(v, s),
        "ScalarMax": lambda v, s: max(v, s),
    }


class ReduceOp:
    """ref: transform.reduce.ReduceOp."""
    Sum = "Sum"
    Mean = "Mean"
    Min = "Min"
    Max = "Max"
    Count = "Count"
    Stdev = "Stdev"
    First = "First"
    Last = "Last"


def _reduce(op: str, values: List[float]):
    if op == ReduceOp.Sum:
        return sum(values)
    if op == ReduceOp.Mean:
        return sum(values) / len(values)
    if op == ReduceOp.Min:
        return min(values)
    if op == ReduceOp.Max:
        return max(values)
    if op == ReduceOp.Count:
        return len(values)
    if op == ReduceOp.Stdev:
        m = sum(values) / len(values)
        return math.sqrt(sum((v - m) ** 2 for v in values)
                         / max(len(values) - 1, 1))
    if op == ReduceOp.First:
        return values[0]
    if op == ReduceOp.Last:
        return values[-1]
    raise ValueError(op)


# --------------------------------------------------------------- process
class TransformProcess:
    """ref: TransformProcess (+ .Builder). Immutable step list."""

    def __init__(self, initial_schema: Schema, steps):
        self.initial_schema = initial_schema
        self.steps = list(steps)   # [(name, fn(schema, rows)->(schema, rows))]

    def get_final_schema(self) -> Schema:
        schema = self.initial_schema
        for _, fn in self.steps:
            schema, _ = fn(schema, None)
        return schema

    getFinalSchema = get_final_schema

    def execute(self, rows: Sequence[Row]) -> List[Row]:
        schema = self.initial_schema
        rows = [[box(v) for v in r] for r in rows]
        for _, fn in self.steps:
            schema, rows = fn(schema, rows)
        return rows

    class Builder:
        def __init__(self, initial_schema: Schema):
            self.schema = initial_schema
            self._steps = []

        def _add(self, name, fn):
            self._steps.append((name, fn))
            return self

        # --- column removal / renaming / reordering
        def remove_columns(self, *names):
            names = set(names)

            def fn(schema, rows):
                keep = [i for i, c in enumerate(schema.columns)
                        if c.name not in names]
                new_schema = Schema([schema.columns[i] for i in keep])
                if rows is None:
                    return new_schema, None
                return new_schema, [[r[i] for i in keep] for r in rows]
            return self._add("removeColumns", fn)

        removeColumns = remove_columns

        def remove_all_columns_except_for(self, *names):
            keep_names = list(names)

            def fn(schema, rows):
                keep = [schema.get_index_of_column(n) for n in keep_names]
                new_schema = Schema([schema.columns[i] for i in keep])
                if rows is None:
                    return new_schema, None
                return new_schema, [[r[i] for i in keep] for r in rows]
            return self._add("removeAllColumnsExceptFor", fn)

        removeAllColumnsExceptFor = remove_all_columns_except_for

        def rename_column(self, old: str, new: str):
            def fn(schema, rows):
                cols = [ColumnMetaData(new if c.name == old else c.name,
                                       c.column_type, c.state_names)
                        for c in schema.columns]
                return Schema(cols), rows
            return self._add("renameColumn", fn)

        renameColumn = rename_column

        def reorder_columns(self, *names):
            order = list(names)

            def fn(schema, rows):
                idx = [schema.get_index_of_column(n) for n in order]
                rest = [i for i in range(len(schema.columns)) if i not in idx]
                full = idx + rest
                new_schema = Schema([schema.columns[i] for i in full])
                if rows is None:
                    return new_schema, None
                return new_schema, [[r[i] for i in full] for r in rows]
            return self._add("reorderColumns", fn)

        reorderColumns = reorder_columns

        # --- categorical
        def categorical_to_integer(self, *names):
            cols = list(names)

            def fn(schema, rows):
                idxs = {schema.get_index_of_column(n): n for n in cols}
                states = {i: schema.columns[i].state_names for i in idxs}
                new_cols = [ColumnMetaData(c.name, ColumnType.Integer)
                            if i in idxs else c
                            for i, c in enumerate(schema.columns)]
                new_schema = Schema(new_cols)
                if rows is None:
                    return new_schema, None
                out = []
                for r in rows:
                    r = list(r)
                    for i in idxs:
                        r[i] = IntWritable(states[i].index(unbox(r[i])))
                    out.append(r)
                return new_schema, out
            return self._add("categoricalToInteger", fn)

        categoricalToInteger = categorical_to_integer

        def categorical_to_one_hot(self, *names):
            cols = list(names)

            def fn(schema, rows):
                # expand each categorical column into one Integer col per state
                plan = []   # (orig_index, states) in column order
                new_cols = []
                for i, c in enumerate(schema.columns):
                    if c.name in cols:
                        if not c.state_names:
                            raise ValueError(
                                f"column {c.name!r} has no categorical states")
                        plan.append((i, c.state_names))
                        for s in c.state_names:
                            new_cols.append(ColumnMetaData(
                                f"{c.name}[{s}]", ColumnType.Integer))
                    else:
                        plan.append((i, None))
                        new_cols.append(c)
                new_schema = Schema(new_cols)
                if rows is None:
                    return new_schema, None
                out = []
                for r in rows:
                    nr = []
                    for i, states in plan:
                        if states is None:
                            nr.append(r[i])
                        else:
                            v = unbox(r[i])
                            nr.extend(IntWritable(1 if s == v else 0)
                                      for s in states)
                    out.append(nr)
                return new_schema, out
            return self._add("categoricalToOneHot", fn)

        categoricalToOneHot = categorical_to_one_hot

        def integer_to_categorical(self, name, state_names):
            states = list(state_names)

            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                new_cols = list(schema.columns)
                new_cols[i] = ColumnMetaData(name, ColumnType.Categorical,
                                             states)
                new_schema = Schema(new_cols)
                if rows is None:
                    return new_schema, None
                out = []
                for r in rows:
                    r = list(r)
                    r[i] = Text(states[unbox(r[i])])
                    out.append(r)
                return new_schema, out
            return self._add("integerToCategorical", fn)

        integerToCategorical = integer_to_categorical

        def string_to_categorical(self, name, state_names):
            states = list(state_names)

            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                new_cols = list(schema.columns)
                new_cols[i] = ColumnMetaData(name, ColumnType.Categorical,
                                             states)
                return Schema(new_cols), rows
            return self._add("stringToCategorical", fn)

        stringToCategorical = string_to_categorical

        # --- math / conversions
        def double_math_op(self, name, op: str, scalar: float):
            f = MathOp._FNS[op]

            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                if rows is None:
                    return schema, None
                out = []
                for r in rows:
                    r = list(r)
                    r[i] = DoubleWritable(f(r[i].to_double(), scalar))
                    out.append(r)
                return schema, out
            return self._add("doubleMathOp", fn)

        doubleMathOp = double_math_op

        def integer_math_op(self, name, op: str, scalar: int):
            f = MathOp._FNS[op]

            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                if rows is None:
                    return schema, None
                out = []
                for r in rows:
                    r = list(r)
                    r[i] = IntWritable(int(f(r[i].to_int(), scalar)))
                    out.append(r)
                return schema, out
            return self._add("integerMathOp", fn)

        integerMathOp = integer_math_op

        def convert_to_double(self, *names):
            cols = list(names)

            def fn(schema, rows):
                idxs = [schema.get_index_of_column(n) for n in cols]
                new_cols = [ColumnMetaData(c.name, ColumnType.Double)
                            if i in idxs else c
                            for i, c in enumerate(schema.columns)]
                new_schema = Schema(new_cols)
                if rows is None:
                    return new_schema, None
                out = []
                for r in rows:
                    r = list(r)
                    for i in idxs:
                        r[i] = DoubleWritable(r[i].to_double())
                    out.append(r)
                return new_schema, out
            return self._add("convertToDouble", fn)

        convertToDouble = convert_to_double

        def normalize(self, name, kind: str, *stats):
            """kind: 'MinMax' (needs min,max) or 'Standardize' (mean,std)
            (ref: transform.normalize.Normalize; stats from DataAnalysis)."""
            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                if rows is None:
                    return schema, None
                vals = [r[i].to_double() for r in rows]
                if kind.lower() == "minmax":
                    lo, hi = stats if stats else (min(vals), max(vals))
                    rng = (hi - lo) or 1.0
                    conv = lambda v: (v - lo) / rng
                else:
                    if stats:
                        mu, sd = stats
                    else:
                        mu = sum(vals) / len(vals)
                        sd = math.sqrt(sum((v - mu) ** 2 for v in vals)
                                       / max(len(vals) - 1, 1)) or 1.0
                    conv = lambda v: (v - mu) / sd
                out = []
                for r in rows:
                    r = list(r)
                    r[i] = DoubleWritable(conv(r[i].to_double()))
                    out.append(r)
                return schema, out
            return self._add("normalize", fn)

        # --- filtering
        def filter(self, condition: Condition):
            """Remove rows MATCHING the condition (ref:
            filter.ConditionFilter semantics)."""
            def fn(schema, rows):
                if rows is None:
                    return schema, None
                return schema, [r for r in rows
                                if not condition.matches(schema, r)]
            return self._add("filter", fn)

        def conditional_replace_value_transform(self, name, new_value,
                                                condition: Condition):
            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                if rows is None:
                    return schema, None
                out = []
                for r in rows:
                    if condition.matches(schema, r):
                        r = list(r)
                        r[i] = box(new_value)
                    out.append(r)
                return schema, out
            return self._add("conditionalReplaceValueTransform", fn)

        conditionalReplaceValueTransform = conditional_replace_value_transform

        # --- reduction (groupBy)
        def reduce(self, key_column: str, ops: dict):
            """Group rows by ``key_column``; ``ops`` maps column → ReduceOp
            (ref: transform.reduce.Reducer)."""
            def fn(schema, rows):
                kidx = schema.get_index_of_column(key_column)
                new_cols = [schema.columns[kidx]]
                col_idx = {}
                for col, op in ops.items():
                    i = schema.get_index_of_column(col)
                    col_idx[col] = i
                    ctype = (ColumnType.Integer if op == ReduceOp.Count
                             else ColumnType.Double)
                    new_cols.append(ColumnMetaData(f"{op.lower()}({col})",
                                                   ctype))
                new_schema = Schema(new_cols)
                if rows is None:
                    return new_schema, None
                groups = {}
                for r in rows:
                    groups.setdefault(unbox(r[kidx]), []).append(r)
                out = []
                for k, grp in groups.items():
                    row = [box(k)]
                    for col, op in ops.items():
                        vals = [g[col_idx[col]].to_double() for g in grp]
                        row.append(box(_reduce(op, vals)))
                    out.append(row)
                return new_schema, out
            return self._add("reduce", fn)

        # --- column structure (ref: transform.column.* /
        # DuplicateColumnsTransform / AddConstantColumnTransform)
        def add_constant_column(self, name, column_type: str, value):
            def fn(schema, rows):
                ns = Schema(schema.columns
                            + [ColumnMetaData(name, column_type)])
                if rows is None:
                    return ns, None
                return ns, [r + [box(value)] for r in rows]
            return self._add("add_constant_column", fn)

        def duplicate_column(self, src: str, new_name: str):
            def fn(schema, rows):
                i = schema.get_index_of_column(src)
                meta = schema.columns[i]
                ns = Schema(schema.columns
                            + [ColumnMetaData(new_name, meta.column_type)])
                if rows is None:
                    return ns, None
                return ns, [r + [r[i]] for r in rows]
            return self._add("duplicate_column", fn)

        # --- string transforms (ref: transform.string.*)
        def _string_op(self, label, name, op):
            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                if rows is None:
                    return schema, None
                out = []
                for r in rows:
                    r = list(r)
                    r[i] = box(op(str(unbox(r[i]))))
                    out.append(r)
                return schema, out
            return self._add(label, fn)

        def append_string_column_transform(self, name, to_append: str):
            return self._string_op("append_string", name,
                                   lambda v: v + to_append)

        def change_case_transform(self, name, case: str = "lower"):
            return self._string_op(
                "change_case", name,
                (str.lower if case.lower() == "lower" else str.upper))

        def replace_string_transform(self, name, mapping: dict):
            """Regex → replacement map, applied in insertion order
            (ref: ReplaceStringTransform)."""
            import re

            def op(v):
                for pat, rep in mapping.items():
                    v = re.sub(pat, rep, v)
                return v
            return self._string_op("replace_string", name, op)

        def string_map_transform(self, name, mapping: dict):
            """Exact-match relabeling (ref: StringMapTransform)."""
            return self._string_op("string_map", name,
                                   lambda v: mapping.get(v, v))

        def concat_string_columns(self, new_name, delimiter, *names):
            def fn(schema, rows):
                idx = [schema.get_index_of_column(n) for n in names]
                ns = Schema(schema.columns
                            + [ColumnMetaData(new_name, ColumnType.String)])
                if rows is None:
                    return ns, None
                return ns, [r + [box(delimiter.join(str(unbox(r[i]))
                                                    for i in idx))]
                            for r in rows]
            return self._add("concat_string_columns", fn)

        # --- time transforms (ref: transform.time.StringToTimeTransform /
        # DeriveColumnsFromTimeTransform)
        def string_to_time_transform(self, name,
                                     fmt: str = "%Y-%m-%d %H:%M:%S"):
            import datetime as _dt

            def fn(schema, rows):
                i = schema.get_index_of_column(name)
                ns = Schema(list(schema.columns))
                ns.columns[i] = ColumnMetaData(name, ColumnType.Time)
                if rows is None:
                    return ns, None
                out = []
                for r in rows:
                    r = list(r)
                    t = _dt.datetime.strptime(str(unbox(r[i])), fmt)
                    r[i] = box(int(t.replace(
                        tzinfo=_dt.timezone.utc).timestamp() * 1000))
                    out.append(r)
                return ns, out
            return self._add("string_to_time", fn)

        def derive_columns_from_time(self, source: str, *fields):
            """fields ⊆ {year, month, day, hour, minute, second,
            day_of_week} → new integer columns named source_<field>."""
            import datetime as _dt

            def fn(schema, rows):
                i = schema.get_index_of_column(source)
                ns = Schema(schema.columns
                            + [ColumnMetaData(f"{source}_{f}", ColumnType.Integer)
                               for f in fields])
                if rows is None:
                    return ns, None
                out = []
                for r in rows:
                    t = _dt.datetime.fromtimestamp(
                        unbox(r[i]) / 1000.0, _dt.timezone.utc)
                    vals = {"year": t.year, "month": t.month, "day": t.day,
                            "hour": t.hour, "minute": t.minute,
                            "second": t.second,
                            "day_of_week": t.weekday()}
                    out.append(list(r) + [box(vals[f]) for f in fields])
                return ns, out
            return self._add("derive_columns_from_time", fn)

        # --- column-vs-column math (ref: DoubleColumnsMathOpTransform).
        # Folds MathOp._FNS pairwise left-to-right (the scalar-only ops
        # ScalarMin/ScalarMax double as pairwise Min/Max); division follows
        # Java double semantics (inf/nan, never a crash)
        def double_columns_math_op(self, new_name, op: str, *names):
            key = {"Max": "ScalarMax", "Min": "ScalarMin"}.get(op, op)
            pair = MathOp._FNS.get(key)
            if pair is None:
                raise ValueError(f"unknown op {op!r}; have "
                                 f"{sorted(MathOp._FNS)} + Max/Min")

            def fold(vals):
                import math
                acc = vals[0]
                for x in vals[1:]:
                    try:
                        acc = pair(acc, x)
                    except ZeroDivisionError:
                        # Java double semantics: x % 0 = NaN; x / 0 = ±inf
                        # (0/0 = NaN)
                        acc = (math.nan if key == "Modulus" or acc == 0
                               else math.copysign(math.inf, acc))
                return acc

            def fn(schema, rows):
                idx = [schema.get_index_of_column(n) for n in names]
                ns = Schema(schema.columns
                            + [ColumnMetaData(new_name, ColumnType.Double)])
                if rows is None:
                    return ns, None
                return ns, [list(r) + [box(float(fold(
                    [r[i].to_double() for i in idx])))] for r in rows]
            return self._add("double_columns_math_op", fn)

        doubleColumnsMathOp = double_columns_math_op

        addConstantColumn = add_constant_column
        duplicateColumn = duplicate_column
        appendStringColumnTransform = append_string_column_transform
        changeCaseTransform = change_case_transform
        replaceStringTransform = replace_string_transform
        stringMapTransform = string_map_transform
        concatStringColumns = concat_string_columns
        stringToTimeTransform = string_to_time_transform
        deriveColumnsFromTime = derive_columns_from_time

        # --- custom escape hatch
        def transform(self, name, fn):
            """Custom step: fn(schema, rows) -> (schema, rows)."""
            return self._add(name, fn)

        def build(self) -> "TransformProcess":
            return TransformProcess(self.schema, self._steps)
