"""CIFAR-10 / EMNIST / TinyImageNet dataset iterators: counterpart of
``deeplearning4j_tpu/data/vision.py``, analogs of
``org.deeplearning4j.datasets.iterator.impl.{Cifar10DataSetIterator,
EmnistDataSetIterator,TinyImageNetDataSetIterator}`` (+ their fetchers in
``org.deeplearning4j.datasets.fetchers`` — SURVEY D13).

Zero-egress environment: the reference downloads archives into ``~/.nd4j``
via ``Downloader``; here each iterator (a) reads the dataset's STANDARD
on-disk format if present under ``$DL4J_TPU_DATA_DIR`` (CIFAR binary
batches, EMNIST IDX files, TinyImageNet class directories), else (b) falls
back to a deterministic, learnable synthetic generator with the same
shapes/classes/API, flagged via ``.synthetic`` — same policy as
``data/mnist.py``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.data.mnist import _find_idx, _read_idx


def _data_root(data_dir: Optional[str]) -> Path:
    return Path(data_dir or os.environ.get(
        "DL4J_TPU_DATA_DIR", Path.home() / ".deeplearning4j_tpu"))


def _synthetic_images(n: int, num_classes: int, hw: int, channels: int,
                      seed: int):
    """Deterministic learnable images: each class is an oriented grating with
    a class-specific frequency/phase/colour, plus noise. A small CNN reaches
    high accuracy; chance accuracy is 1/num_classes."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    imgs = np.zeros((n, hw, hw, channels), np.float32)
    for i, lab in enumerate(labels):
        angle = np.pi * lab / num_classes
        freq = 2.0 + 3.0 * (lab % 5)
        phase = rng.uniform(0, np.pi)
        wave = np.sin(2 * np.pi * freq *
                      (np.cos(angle) * xx + np.sin(angle) * yy) + phase)
        base = 0.5 + 0.5 * wave
        for c in range(channels):
            gain = 0.4 + 0.6 * (((lab + c) % channels + 1) / channels)
            imgs[i, :, :, c] = base * gain
        imgs[i] += rng.normal(0, 0.05, (hw, hw, channels))
    return np.clip(imgs, 0, 1).astype(np.float32), labels


# ------------------------------------------------------------------ CIFAR-10
def load_cifar10(train: bool = True, data_dir: Optional[str] = None):
    """(images [N,32,32,3] float32 in [0,1], labels [N], synthetic flag).
    Reads the standard CIFAR-10 binary batches (1 label byte + 3072
    channel-planar bytes per row) from ``<root>/cifar10/``."""
    base = _data_root(data_dir) / "cifar10"
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    paths = [base / nm for nm in names]
    # also accept the cifar-10-batches-bin subdir of the official archive
    if not all(p.exists() for p in paths):
        alt = base / "cifar-10-batches-bin"
        paths = [alt / nm for nm in names]
    if all(p.exists() for p in paths):
        imgs, labels = [], []
        for p in paths:
            raw = np.frombuffer(p.read_bytes(), np.uint8).reshape(-1, 3073)
            labels.append(raw[:, 0].astype(np.int64))
            imgs.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1))          # planar RGB → NHWC
        return (np.concatenate(imgs).astype(np.float32) / 255.0,
                np.concatenate(labels), False)
    n = 8192 if train else 2048
    imgs, labels = _synthetic_images(n, 10, 32, 3, seed=10 if train else 11)
    return imgs, labels, True


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """(ref: Cifar10DataSetIterator(batch[, train])) — NHWC float32 features,
    one-hot 10-class labels."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None,
                 data_dir: Optional[str] = None):
        imgs, labels, synthetic = load_cifar10(train, data_dir)
        if num_examples is not None:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        self.synthetic = synthetic
        onehot = np.eye(10, dtype=np.float32)[labels]
        super().__init__(imgs, onehot, batch_size, shuffle=train, seed=seed)


CifarDataSetIterator = Cifar10DataSetIterator    # reference alias (older name)


# -------------------------------------------------------------------- EMNIST
_EMNIST_CLASSES = {"digits": 10, "mnist": 10, "letters": 26,
                   "balanced": 47, "bymerge": 47, "byclass": 62}


class EmnistDataSetIterator(ArrayDataSetIterator):
    """(ref: EmnistDataSetIterator(Set, batch, train)) — EMNIST variants with
    their class counts; reads ``emnist-<set>-{train,test}-*-idx*-ubyte[.gz]``
    IDX files from ``<root>/emnist/``."""

    SETS = tuple(_EMNIST_CLASSES)

    def __init__(self, which: str, batch_size: int, train: bool = True,
                 seed: int = 123, num_examples: Optional[int] = None,
                 flatten: bool = True, data_dir: Optional[str] = None):
        which = which.lower()
        if which not in _EMNIST_CLASSES:
            raise ValueError(f"unknown EMNIST set {which!r}; one of {self.SETS}")
        self.which = which
        self.num_classes_ = _EMNIST_CLASSES[which]
        base = _data_root(data_dir) / "emnist"
        split = "train" if train else "test"
        pi = _find_idx(base, f"emnist-{which}-{split}-images-idx3-ubyte")
        pl = _find_idx(base, f"emnist-{which}-{split}-labels-idx1-ubyte")
        if pi is not None and pl is not None:
            imgs = _read_idx(pi).astype(np.float32) / 255.0
            labels = _read_idx(pl).astype(np.int64)
            # EMNIST 'letters' labels are 1-indexed
            if which == "letters" and labels.min() >= 1:
                labels = labels - 1
            self.synthetic = False
        else:
            n = 8192 if train else 2048
            imgs, labels = _synthetic_images(
                n, self.num_classes_, 28, 1, seed=20 if train else 21)
            imgs = imgs[..., 0]
            self.synthetic = True
        if num_examples is not None:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        feats = (imgs.reshape(len(imgs), -1) if flatten else imgs[..., None])
        onehot = np.eye(self.num_classes_, dtype=np.float32)[labels]
        super().__init__(feats.astype(np.float32), onehot, batch_size,
                         shuffle=train, seed=seed)

    def num_classes(self) -> int:
        return self.num_classes_

    numLabels = num_classes


# -------------------------------------------------------------- TinyImageNet
class TinyImageNetDataSetIterator(ArrayDataSetIterator):
    """(ref: TinyImageNetDataSetIterator(batch[, numExamples])) — 200-class
    64×64 RGB. Reads the standard extracted layout
    ``<root>/tiny-imagenet-200/train/<wnid>/images/*.JPEG`` via PIL when
    present; synthetic fallback otherwise."""

    HW = 64
    NUM_CLASSES = 200

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 data_dir: Optional[str] = None):
        self.num_classes_ = num_classes or self.NUM_CLASSES
        base = _data_root(data_dir) / "tiny-imagenet-200"
        split_dir = base / ("train" if train else "val")
        imgs = labels = None
        if split_dir.is_dir():
            imgs, labels = self._load_dir(split_dir, train, num_examples)
        if imgs is None:
            n = num_examples or (4096 if train else 1024)
            imgs, labels = _synthetic_images(
                n, self.num_classes_, self.HW, 3, seed=30 if train else 31)
            self.synthetic = True
        else:
            self.synthetic = False
            if num_examples is not None:
                imgs, labels = imgs[:num_examples], labels[:num_examples]
        onehot = np.eye(self.num_classes_, dtype=np.float32)[labels]
        super().__init__(imgs, onehot, batch_size, shuffle=train, seed=seed)

    def _load_dir(self, split_dir: Path, train: bool,
                  num_examples: Optional[int]):
        try:
            from PIL import Image
        except ImportError:
            return None, None
        wnids = sorted(d.name for d in (split_dir.parent / "train").iterdir()
                       if d.is_dir())[: self.num_classes_]
        cls = {w: i for i, w in enumerate(wnids)}
        imgs, labels = [], []
        if train:
            for w in wnids:
                for p in sorted((split_dir / w / "images").glob("*.JPEG")):
                    imgs.append(np.asarray(
                        Image.open(p).convert("RGB"), np.float32) / 255.0)
                    labels.append(cls[w])
                    if num_examples and len(imgs) >= num_examples:
                        break
                if num_examples and len(imgs) >= num_examples:
                    break
        else:
            ann = split_dir / "val_annotations.txt"
            if not ann.exists():
                return None, None
            for line in ann.read_text().splitlines():
                parts = line.split("\t")
                if len(parts) < 2 or parts[1] not in cls:
                    continue
                p = split_dir / "images" / parts[0]
                if not p.exists():
                    continue
                imgs.append(np.asarray(
                    Image.open(p).convert("RGB"), np.float32) / 255.0)
                labels.append(cls[parts[1]])
                if num_examples and len(imgs) >= num_examples:
                    break
        if not imgs:
            return None, None
        return np.stack(imgs), np.asarray(labels, np.int64)

    def num_classes(self) -> int:
        return self.num_classes_
