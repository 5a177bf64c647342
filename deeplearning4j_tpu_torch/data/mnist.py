"""MNIST / EMNIST-style dataset iterators: counterpart of
``deeplearning4j_tpu/data/mnist.py``, analog of
``org.deeplearning4j.datasets.iterator.impl.MnistDataSetIterator`` (SURVEY
D13).

Zero-egress environment: the reference downloads MNIST into ``~/.nd4j``; here
we (a) read standard IDX files if present under ``$DL4J_TPU_DATA_DIR`` or
``~/.deeplearning4j_tpu/mnist``, else (b) fall back to a deterministic
synthetic digit generator (procedurally rendered digit glyphs + noise) that
is learnable and keeps the same shapes/API, so examples and convergence
tests run anywhere. The fallback is clearly flagged via ``.synthetic``.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator

_GLYPHS = [
    # 7x7 coarse digit glyphs, upsampled to 28x28 — synthetic fallback
    "011111010000011010001101000110100011010000110111110",
    "0001000001100000010000000100000001000000010001111100",
    "0111110100000100000010000110001100010000011111111110",
    "0111110100000100000010001110000000110000011011111000",
    "0000110000101000100100100101000010111111100000100000",
    "1111111100000010111100000001000000010000011011111000",
    "0011110010000010000001011110110000110100001101111100",
    "1111111000000100000100000100000100000100000010000000",
    "0111110100000101000001011111010000011000001101111100",
    "0111110100000110000011011111100000010000010011110000",
]


def _render_digit(d: int) -> np.ndarray:
    bits = _GLYPHS[d][:49]
    g = np.array([int(b) for b in bits], dtype=np.float32).reshape(7, 7)
    return np.kron(g, np.ones((4, 4), dtype=np.float32))  # 28x28


def synthetic_mnist(n: int, seed: int = 0):
    """Deterministic learnable digit images: glyph + jitter + noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    imgs = np.zeros((n, 28, 28), dtype=np.float32)
    glyphs = np.stack([_render_digit(d) for d in range(10)])
    for i, lab in enumerate(labels):
        img = glyphs[lab]
        dx, dy = rng.integers(-2, 3, size=2)
        img = np.roll(np.roll(img, dx, axis=0), dy, axis=1)
        img = img * rng.uniform(0.7, 1.0) + rng.normal(0, 0.08, img.shape)
        imgs[i] = np.clip(img, 0, 1)
    return imgs, labels


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find_idx(data_dir: Path, stem: str) -> Optional[Path]:
    for suffix in ("", ".gz"):
        p = data_dir / (stem + suffix)
        if p.exists():
            return p
    return None


def load_mnist(train: bool = True, data_dir: Optional[str] = None):
    """(images [N,28,28] float32 in [0,1], labels [N] int) — real if IDX
    files found, else synthetic."""
    base = Path(data_dir or os.environ.get("DL4J_TPU_DATA_DIR",
                                           Path.home() / ".deeplearning4j_tpu")) / "mnist"
    stem_img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    stem_lab = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    pi, pl = _find_idx(base, stem_img), _find_idx(base, stem_lab)
    if pi is not None and pl is not None:
        return _read_idx(pi).astype(np.float32) / 255.0, _read_idx(pl).astype(np.int64), False
    n = 8192 if train else 2048
    imgs, labels = synthetic_mnist(n, seed=0 if train else 1)
    return imgs, labels, True


class MnistDataSetIterator(ArrayDataSetIterator):
    """(ref: MnistDataSetIterator(batch, train[, seed])). Features are flat
    (N, 784) float32 in [0,1]; labels one-hot (N, 10) — matching the
    reference's LeNetMNIST example input contract."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123,
                 flatten: bool = True, num_examples: Optional[int] = None,
                 data_dir: Optional[str] = None):
        imgs, labels, synthetic = load_mnist(train, data_dir)
        if num_examples is not None:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        self.synthetic = synthetic
        feats = imgs.reshape(len(imgs), -1) if flatten else imgs[..., None]  # NHWC
        onehot = np.eye(10, dtype=np.float32)[labels]
        super().__init__(feats.astype(np.float32), onehot, batch_size,
                         shuffle=train, seed=seed)
