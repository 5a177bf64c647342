"""Data normalizers: counterpart of ``deeplearning4j_tpu/data/normalizers.py``
(the reference's ``org.nd4j.linalg.dataset.api.preprocessor``:
NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler,
VGG16ImagePreProcessor).

Fit runs on the host in numpy, as in the reference, so the statistics are
the reference's f32 arrays bit for bit. Transform and revert take numpy
features (the reference's arithmetic) or tensors on any device (the same
formulas in torch, the statistics moved to the batch's device).
``state_dict`` / ``load_state_dict`` keep the reference's keys, so a
normalizer saved in a zip by either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _like(stat, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(stat), device=x.device).to(x.dtype)


class DataNormalization:
    def fit(self, source):
        """Accepts a DataSet or an iterator of DataSets."""
        if isinstance(source, DataSet):
            self._fit_arrays([_host(source.features)])
        else:
            source.reset()
            feats = [_host(ds.features) for ds in source]
            self._fit_arrays(feats)
            source.reset()
        return self

    def _fit_arrays(self, arrays):
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        ds.features = self._transform_array(ds.features)
        return ds

    def pre_process(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    preProcess = pre_process

    def _transform_array(self, x):
        raise NotImplementedError

    def revert(self, ds: DataSet) -> DataSet:
        ds.features = self._revert_array(ds.features)
        return ds

    def _revert_array(self, x):
        raise NotImplementedError

    # serialization hooks used by ModelSerializer
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict):
        pass


class NormalizerStandardize(DataNormalization):
    """Zero-mean unit-variance per feature (ref: NormalizerStandardize)."""

    def __init__(self):
        self.mean = None
        self.std = None

    def _fit_arrays(self, arrays):
        x = np.concatenate([a.reshape(a.shape[0], -1) for a in arrays])
        self.mean = x.mean(axis=0)
        self.std = x.std(axis=0) + 1e-8

    def _transform_array(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        if isinstance(x, torch.Tensor):
            return ((flat - _like(self.mean, x)) / _like(self.std, x)
                    ).reshape(shape)
        return ((flat - self.mean) / self.std).reshape(shape).astype(x.dtype)

    def _revert_array(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        if isinstance(x, torch.Tensor):
            return (flat * _like(self.std, x) + _like(self.mean, x)
                    ).reshape(shape)
        return (flat * self.std + self.mean).reshape(shape).astype(x.dtype)

    def state_dict(self):
        return {"type": "standardize", "mean": self.mean, "std": self.std}

    def load_state_dict(self, d):
        self.mean, self.std = d["mean"], d["std"]


class NormalizerMinMaxScaler(DataNormalization):
    """Scale to [min, max] (ref: NormalizerMinMaxScaler)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min = None
        self.data_max = None

    def _fit_arrays(self, arrays):
        x = np.concatenate([a.reshape(a.shape[0], -1) for a in arrays])
        self.data_min = x.min(axis=0)
        self.data_max = x.max(axis=0)

    def _scale(self):
        scale = self.data_max - self.data_min
        return np.where(scale == 0, 1.0, scale)

    def _transform_array(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        span = self.max_range - self.min_range
        if isinstance(x, torch.Tensor):
            unit = (flat - _like(self.data_min, x)) / _like(self._scale(), x)
            return (unit * span + self.min_range).reshape(shape)
        unit = (flat - self.data_min) / self._scale()
        return (unit * span + self.min_range).reshape(shape).astype(x.dtype)

    def _revert_array(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        unit = (flat - self.min_range) / (self.max_range - self.min_range)
        if isinstance(x, torch.Tensor):
            lo, hi = _like(self.data_min, x), _like(self.data_max, x)
            return (unit * (hi - lo) + lo).reshape(shape)
        return (unit * (self.data_max - self.data_min) + self.data_min
                ).reshape(shape).astype(x.dtype)

    def state_dict(self):
        return {"type": "minmax", "min_range": self.min_range,
                "max_range": self.max_range,
                "data_min": self.data_min, "data_max": self.data_max}

    def load_state_dict(self, d):
        self.min_range, self.max_range = d["min_range"], d["max_range"]
        self.data_min, self.data_max = d["data_min"], d["data_max"]


class ImagePreProcessingScaler(DataNormalization):
    """Pixel [0,255] → [a,b] without fitting (ref: ImagePreProcessingScaler)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, source):
        return self

    def _fit_arrays(self, arrays):
        pass

    def _transform_array(self, x):
        out = (x / self.max_pixel * (self.max_range - self.min_range)
               + self.min_range)
        if isinstance(x, torch.Tensor):
            return out.float()
        return out.astype(np.float32)

    def _revert_array(self, x):
        out = ((x - self.min_range) / (self.max_range - self.min_range)
               * self.max_pixel)
        if isinstance(x, torch.Tensor):
            return out.float()
        return out.astype(np.float32)

    def state_dict(self):
        return {"type": "image", "min_range": self.min_range,
                "max_range": self.max_range, "max_pixel": self.max_pixel}

    def load_state_dict(self, d):
        self.min_range, self.max_range, self.max_pixel = (
            d["min_range"], d["max_range"], d["max_pixel"])


class VGG16ImagePreProcessor(DataNormalization):
    """Subtract ImageNet channel means, RGB order, NHWC (ref:
    VGG16ImagePreProcessor — reference means BGR/NCHW; layout diverges)."""

    MEANS = np.asarray([123.68, 116.779, 103.939], dtype=np.float32)

    def fit(self, source):
        return self

    def _fit_arrays(self, arrays):
        pass

    def _transform_array(self, x):
        if isinstance(x, torch.Tensor):
            return x.float() - _like(self.MEANS, x.float())
        return (x - self.MEANS).astype(np.float32)

    def _revert_array(self, x):
        if isinstance(x, torch.Tensor):
            return x.float() + _like(self.MEANS, x.float())
        return (x + self.MEANS).astype(np.float32)

    def state_dict(self):
        return {"type": "vgg16"}


#: ``normalizer.json``'s "type" → class, as the reference's restore reads it
NORMALIZERS = {"standardize": NormalizerStandardize,
               "minmax": NormalizerMinMaxScaler,
               "image": ImagePreProcessingScaler,
               "vgg16": VGG16ImagePreProcessor}
