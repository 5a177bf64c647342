"""Record readers + input splits
(ref: org.datavec.api.records.reader.* / org.datavec.api.split.*, SURVEY E1).
"""
from __future__ import annotations

import csv
import glob as _glob
import io
import os
from typing import Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.datavec.writable import (BooleanWritable,
                                                 DoubleWritable, IntWritable,
                                                 Text, Writable, box)


# ---------------------------------------------------------------- splits
class InputSplit:
    def locations(self) -> List[str]:
        raise NotImplementedError


class FileSplit(InputSplit):
    """ref: org.datavec.api.split.FileSplit — a file or directory (optionally
    filtered by extensions, optionally shuffled with a seed)."""

    def __init__(self, path, allowed_extensions: Optional[Sequence[str]] = None,
                 random_seed: Optional[int] = None):
        self.path = str(path)
        self.allowed = ([e if e.startswith(".") else "." + e
                         for e in allowed_extensions]
                        if allowed_extensions else None)
        self.seed = random_seed

    def locations(self) -> List[str]:
        if os.path.isfile(self.path):
            files = [self.path]
        else:
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(self.path) for f in fs)
        if self.allowed:
            files = [f for f in files
                     if os.path.splitext(f)[1].lower() in self.allowed]
        if self.seed is not None:
            import random
            rnd = random.Random(self.seed)
            rnd.shuffle(files)
        return files


class ListStringSplit(InputSplit):
    """ref: org.datavec.api.split.ListStringSplit — in-memory data."""

    def __init__(self, data: Sequence[Sequence[str]]):
        self.data = [list(r) for r in data]

    def locations(self):
        return []


class StringSplit(InputSplit):
    def __init__(self, data: str):
        self.data = data

    def locations(self):
        return []


# ---------------------------------------------------------------- readers
class RecordReader:
    """ref: records.reader.RecordReader — iterator of rows of Writables."""

    def initialize(self, split: InputSplit):
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    hasNext = has_next

    def next(self) -> List[Writable]:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()

    def close(self):
        pass


class _ListBackedReader(RecordReader):
    def __init__(self):
        self._rows: List[List[Writable]] = []
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._rows)

    def next(self):
        r = self._rows[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


def _parse_field(s: str) -> Writable:
    """CSV field → typed Writable (int → double → text), matching the
    reference's lazy-parse behavior closely enough for TransformProcess."""
    try:
        return IntWritable(int(s))
    except ValueError:
        pass
    try:
        return DoubleWritable(float(s))
    except ValueError:
        pass
    return Text(s)


class CSVRecordReader(_ListBackedReader):
    """ref: records.reader.impl.csv.CSVRecordReader."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        super().__init__()
        self.skip = skip_num_lines
        self.delimiter = delimiter

    def initialize(self, split: InputSplit):
        self._rows = []
        if isinstance(split, ListStringSplit):
            for r in split.data:
                self._rows.append([_parse_field(str(v)) for v in r])
        else:
            for path in split.locations():
                with open(path, newline="") as f:
                    reader = csv.reader(f, delimiter=self.delimiter)
                    for i, row in enumerate(reader):
                        if i < self.skip or not row:
                            continue
                        self._rows.append([_parse_field(v.strip())
                                           for v in row])
        self._pos = 0
        return self


class LineRecordReader(_ListBackedReader):
    """ref: records.reader.impl.LineRecordReader — one Text per line."""

    def initialize(self, split: InputSplit):
        self._rows = []
        if isinstance(split, StringSplit):
            for line in split.data.splitlines():
                self._rows.append([Text(line)])
        else:
            for path in split.locations():
                with open(path) as f:
                    for line in f:
                        self._rows.append([Text(line.rstrip("\n"))])
        self._pos = 0
        return self


class CollectionRecordReader(_ListBackedReader):
    """ref: records.reader.impl.collection.CollectionRecordReader —
    pre-built in-memory records."""

    def __init__(self, records: Iterable[Sequence]):
        super().__init__()
        self._rows = [[box(v) for v in r] for r in records]

    def initialize(self, split=None):
        return self


class SequenceRecordReader(RecordReader):
    """ref: records.reader.SequenceRecordReader — each item is a sequence
    (list of timesteps, each a row of Writables)."""

    def sequence_record(self) -> List[List[Writable]]:
        raise NotImplementedError


class CSVSequenceRecordReader(SequenceRecordReader):
    """ref: records.reader.impl.csv.CSVSequenceRecordReader — one file per
    sequence; each line is a timestep."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        self.skip = skip_num_lines
        self.delimiter = delimiter
        self._seqs: List[List[List[Writable]]] = []
        self._pos = 0

    def initialize(self, split: InputSplit):
        self._seqs = []
        for path in split.locations():
            seq = []
            with open(path, newline="") as f:
                reader = csv.reader(f, delimiter=self.delimiter)
                for i, row in enumerate(reader):
                    if i < self.skip or not row:
                        continue
                    seq.append([_parse_field(v.strip()) for v in row])
            self._seqs.append(seq)
        self._pos = 0
        return self

    def has_next(self):
        return self._pos < len(self._seqs)

    def next(self):
        s = self._seqs[self._pos]
        self._pos += 1
        return s

    next_sequence = next
    nextSequence = next

    def reset(self):
        self._pos = 0


class TransformProcessRecordReader(RecordReader):
    """Wrap a reader with a TransformProcess applied per record
    (ref: records.reader.impl.transform.TransformProcessRecordReader)."""

    def __init__(self, reader: RecordReader, transform_process):
        self.reader = reader
        self.tp = transform_process
        self._buffer = None

    def initialize(self, split: InputSplit):
        self.reader.initialize(split)
        return self

    def _fill(self):
        while self._buffer is None and self.reader.has_next():
            out = self.tp.execute([self.reader.next()])
            if out:               # filters may drop the record
                self._buffer = out[0]

    def has_next(self):
        self._fill()
        return self._buffer is not None

    def next(self):
        self._fill()
        if self._buffer is None:
            raise StopIteration
        r, self._buffer = self._buffer, None
        return r

    def reset(self):
        self.reader.reset()
        self._buffer = None


class RegexLineRecordReader(_ListBackedReader):
    """ref: records.reader.impl.regex.RegexLineRecordReader — each line is
    matched against a regex; capture groups become the record's columns."""

    def __init__(self, regex: str, skip_num_lines: int = 0):
        import re
        super().__init__()
        self.pattern = re.compile(regex)
        self.skip = skip_num_lines

    def initialize(self, split: InputSplit):
        self._rows = []
        for path in split.locations():
            with open(path) as f:
                for i, line in enumerate(f):
                    if i < self.skip:
                        continue
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    m = self.pattern.fullmatch(line)
                    if m is None:
                        raise ValueError(
                            f"line {i} of {path} does not match pattern "
                            f"{self.pattern.pattern!r}: {line!r}")
                    self._rows.append([_parse_field(g)
                                       for g in m.groups()])
        self._pos = 0
        return self


class JacksonLineRecordReader(_ListBackedReader):
    """ref: records.reader.impl.jackson.JacksonLineRecordReader — one JSON
    object per line; ``field_selection`` names the columns to extract (dotted
    paths supported), mirroring the reference's FieldSelection."""

    def __init__(self, field_selection: Sequence[str]):
        super().__init__()
        self.fields = list(field_selection)

    def _extract(self, obj, dotted: str):
        cur = obj
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return None
            cur = cur[part]
        return cur

    def initialize(self, split: InputSplit):
        import json as _json
        self._rows = []
        for path in split.locations():
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    obj = _json.loads(line)
                    row = []
                    for fld in self.fields:
                        v = self._extract(obj, fld)
                        if v is None:
                            row.append(Text(""))
                        elif isinstance(v, bool):
                            row.append(BooleanWritable(v))
                        elif isinstance(v, int):
                            row.append(IntWritable(v))
                        elif isinstance(v, float):
                            row.append(DoubleWritable(v))
                        else:
                            row.append(Text(str(v)))
                    self._rows.append(row)
        self._pos = 0
        return self


def csv_to_matrix(split: InputSplit, delimiter: str = ",",
                  skip_num_lines: int = 0):
    """Bulk-load numeric CSV files into one float32 matrix (ref analog:
    the reference's ETL hot loops run native — SURVEY N8/N11; the port
    parses with :func:`csv_read_floats`, the JAX package's numpy path:
    fields that fail to parse are NaN, ``skip_num_lines`` counts non-blank
    rows).

    The row-of-Writables ``CSVRecordReader`` remains the general path for
    typed/string columns; this is the fast path for all-numeric tables
    feeding ``DataSet`` construction directly.
    """
    import numpy as np

    locations = split.locations()
    if not locations:
        raise FileNotFoundError(f"csv_to_matrix: split has no locations "
                                f"({split!r})")
    mats = [csv_read_floats(p, delimiter=delimiter, skip_rows=skip_num_lines)
            for p in locations]
    return mats[0] if len(mats) == 1 else np.concatenate(mats, axis=0)


def csv_read_floats(path: str, delimiter: str = ",",
                    skip_rows: int = 0):
    """Parse a numeric CSV file into a (rows, cols) float32 array; fields
    that fail to parse are NaN, short rows are padded with NaN, and
    ``skip_rows`` counts non-blank rows."""
    import numpy as np

    rows = []
    seen = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            seen += 1
            if seen <= skip_rows:
                continue
            vals = []
            for tok in line.rstrip("\n").split(delimiter):
                try:
                    vals.append(float(tok))
                except ValueError:
                    vals.append(float("nan"))
            rows.append(vals)
    width = max((len(r) for r in rows), default=0)
    out = np.full((len(rows), width), np.nan, dtype=np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out
