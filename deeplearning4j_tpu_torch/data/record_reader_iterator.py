"""RecordReader → DataSet bridge iterators: counterpart of
``deeplearning4j_tpu/data/record_reader_iterator.py``
(ref: org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator and
SequenceRecordReaderDataSetIterator, SURVEY D13/L4). They yield the port's
``DataSet`` of numpy arrays; the fit loops move them to the device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.datavec.writable import NDArrayWritable, Writable


def _one_hot(idx: int, n: int) -> np.ndarray:
    v = np.zeros((n,), dtype=np.float32)
    v[idx] = 1.0
    return v


class RecordReaderDataSetIterator(DataSetIterator):
    """Minibatch DataSets from a RecordReader.

    ``label_index`` selects the label column; with ``num_possible_labels``
    the label becomes one-hot (classification), otherwise regression.
    ``label_index_to`` (inclusive) selects multi-column regression labels.
    Records whose first column is an NDArrayWritable (image pipeline) use
    that as features.
    """

    def __init__(self, record_reader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_possible_labels: Optional[int] = None,
                 label_index_to: Optional[int] = None,
                 regression: bool = False):
        self.reader = record_reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_labels = num_possible_labels
        self.label_index_to = label_index_to
        self.regression = regression or (num_possible_labels is None
                                         and label_index is not None
                                         and label_index_to is not None)
        if (label_index is not None and not self.regression
                and num_possible_labels is None):
            raise ValueError(
                "classification needs num_possible_labels; pass it, or set "
                "regression=True / label_index_to for regression labels")

    def _split_record(self, rec: List[Writable]):
        if isinstance(rec[0], NDArrayWritable):
            x = np.asarray(rec[0].value, dtype=np.float32)
            y = None
            if len(rec) > 1:
                li = rec[1].to_int()
                y = (_one_hot(li, self.num_labels)
                     if self.num_labels else np.float32(li))
            return x, y
        vals = rec
        if self.label_index is None:
            return np.array([w.to_double() for w in vals],
                            dtype=np.float32), None
        if self.label_index_to is not None:
            lo, hi = self.label_index, self.label_index_to
            y = np.array([vals[i].to_double() for i in range(lo, hi + 1)],
                         dtype=np.float32)
            x = np.array([vals[i].to_double() for i in range(len(vals))
                          if not lo <= i <= hi], dtype=np.float32)
            return x, y
        x = np.array([w.to_double() for i, w in enumerate(vals)
                      if i != self.label_index], dtype=np.float32)
        if self.regression:
            y = np.float32([vals[self.label_index].to_double()])
        else:
            y = _one_hot(vals[self.label_index].to_int(), self.num_labels)
        return x, y

    def has_next(self) -> bool:
        return self.reader.has_next()

    def next(self) -> DataSet:
        xs, ys = [], []
        while self.reader.has_next() and len(xs) < self.batch_size:
            x, y = self._split_record(self.reader.next())
            xs.append(x)
            if y is not None:
                ys.append(y)
        X = np.stack(xs)
        Y = np.stack(ys) if ys else None
        if Y is not None and Y.ndim == 1:
            Y = Y[:, None]
        return DataSet(X, Y)

    def reset(self):
        self.reader.reset()

    def batch(self) -> int:
        return self.batch_size


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → (N, T, C) DataSets with padding + masks
    (ref: SequenceRecordReaderDataSetIterator ALIGN_END padding)."""

    def __init__(self, sequence_reader, batch_size: int,
                 num_possible_labels: Optional[int] = None,
                 label_index: int = -1, regression: bool = False):
        self.reader = sequence_reader
        self.batch_size = batch_size
        self.num_labels = num_possible_labels
        self.label_index = label_index
        self.regression = regression

    def has_next(self):
        return self.reader.has_next()

    def next(self) -> DataSet:
        seq_x, seq_y = [], []
        while self.reader.has_next() and len(seq_x) < self.batch_size:
            seq = self.reader.next()          # [timestep][col] Writables
            xs, ys = [], []
            for step in seq:
                li = (self.label_index if self.label_index >= 0
                      else len(step) + self.label_index)
                x = [w.to_double() for i, w in enumerate(step) if i != li]
                xs.append(x)
                if self.regression:
                    ys.append([step[li].to_double()])
                elif self.num_labels:
                    ys.append(_one_hot(step[li].to_int(), self.num_labels))
            seq_x.append(np.array(xs, dtype=np.float32))
            if ys:
                seq_y.append(np.array(ys, dtype=np.float32))
        max_t = max(s.shape[0] for s in seq_x)
        n = len(seq_x)
        X = np.zeros((n, max_t, seq_x[0].shape[1]), dtype=np.float32)
        mask = np.zeros((n, max_t), dtype=np.float32)
        for i, s in enumerate(seq_x):
            X[i, :s.shape[0]] = s
            mask[i, :s.shape[0]] = 1.0
        Y = None
        lmask = None
        if seq_y:
            Y = np.zeros((n, max_t, seq_y[0].shape[1]), dtype=np.float32)
            for i, s in enumerate(seq_y):
                Y[i, :s.shape[0]] = s
            lmask = mask
        return DataSet(X, Y, features_mask=mask, labels_mask=lmask)

    def reset(self):
        self.reader.reset()

    def batch(self):
        return self.batch_size
