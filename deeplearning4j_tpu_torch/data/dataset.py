"""Minibatch containers: counterpart of ``deeplearning4j_tpu/data/dataset.py``
(the reference's ``DataSet`` / ``MultiDataSet``). Fields hold numpy arrays,
or tensors where a caller (the device prefetch) placed them; an NDArray
given is held as its tensor. The getters return the port's ``NDArray``, as
the reference's return its own (a numpy field goes to the default
device)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray


def _arr(x):
    if isinstance(x, NDArray):
        x = x.buf()
    if x is None or isinstance(x, torch.Tensor):
        return x
    return np.asarray(x)


class DataSet:
    """features + labels (+ masks) (ref: DataSet)."""

    def __init__(self, features=None, labels=None, features_mask=None, labels_mask=None):
        self.features = _arr(features)
        self.labels = _arr(labels)
        self.features_mask = _arr(features_mask)
        self.labels_mask = _arr(labels_mask)

    def num_examples(self) -> int:
        return 0 if self.features is None else self.features.shape[0]

    numExamples = num_examples

    def get_features(self) -> NDArray:
        return NDArray(self.features)

    def get_labels(self) -> NDArray:
        return NDArray(self.labels)

    getFeatures = get_features
    getLabels = get_labels

    def split_test_and_train(self, n_train: int):
        """(ref: DataSet#splitTestAndTrain)."""
        tr = DataSet(self.features[:n_train], self.labels[:n_train],
                     None if self.features_mask is None else self.features_mask[:n_train],
                     None if self.labels_mask is None else self.labels_mask[:n_train])
        te = DataSet(self.features[n_train:], self.labels[n_train:],
                     None if self.features_mask is None else self.features_mask[n_train:],
                     None if self.labels_mask is None else self.labels_mask[n_train:])
        return tr, te

    splitTestAndTrain = split_test_and_train

    def shuffle(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_examples())
        self.features = self.features[perm]
        self.labels = self.labels[perm]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[perm]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[perm]
        return self

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [DataSet(self.features[i:i + batch_size], self.labels[i:i + batch_size],
                        None if self.features_mask is None else self.features_mask[i:i + batch_size],
                        None if self.labels_mask is None else self.labels_mask[i:i + batch_size])
                for i in range(0, n, batch_size)]

    batchBy = batch_by

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
            None if datasets[0].features_mask is None else np.concatenate([d.features_mask for d in datasets]),
            None if datasets[0].labels_mask is None else np.concatenate([d.labels_mask for d in datasets]))

    def save(self, path):
        np.savez(path, features=self.features, labels=self.labels,
                 **({"features_mask": self.features_mask} if self.features_mask is not None else {}),
                 **({"labels_mask": self.labels_mask} if self.labels_mask is not None else {}))

    @staticmethod
    def load(path) -> "DataSet":
        z = np.load(path)
        return DataSet(z["features"], z["labels"],
                       z["features_mask"] if "features_mask" in z else None,
                       z["labels_mask"] if "labels_mask" in z else None)


class MultiDataSet:
    """Multiple feature/label arrays (ref: MultiDataSet, for ComputationGraph)."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks: Optional[Sequence] = None, labels_masks: Optional[Sequence] = None):
        self.features = [_arr(f) for f in (features if isinstance(features, (list, tuple)) else [features])]
        self.labels = [_arr(l) for l in (labels if isinstance(labels, (list, tuple)) else [labels])]
        self.features_masks = None if features_masks is None else [_arr(m) for m in features_masks]
        self.labels_masks = None if labels_masks is None else [_arr(m) for m in labels_masks]

    def num_examples(self) -> int:
        return self.features[0].shape[0]

    numExamples = num_examples
