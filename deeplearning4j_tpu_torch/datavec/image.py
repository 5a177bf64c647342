"""Image pipeline: loader, record reader, augmentation transforms
(ref: datavec-data-image — org.datavec.image.loader.NativeImageLoader,
recordreader.ImageRecordReader, transform.* — SURVEY E2).

Decode runs on the host (PIL); arrays are NHWC float32, the layout the conv
stack consumes directly (the reference is NCHW — documented divergence).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datavec.records import FileSplit, RecordReader
from deeplearning4j_tpu_torch.datavec.writable import IntWritable, NDArrayWritable


class ImageLoader:
    """Decode an image file/bytes to (H, W, C) float32
    (ref: NativeImageLoader#asMatrix, OpenCV decode)."""

    def __init__(self, height: Optional[int] = None,
                 width: Optional[int] = None, channels: int = 3):
        self.height = height
        self.width = width
        self.channels = channels

    def as_matrix(self, source) -> np.ndarray:
        from PIL import Image
        img = Image.open(source) if not hasattr(source, "convert") else source
        img = img.convert("L" if self.channels == 1 else "RGB")
        if self.height and self.width:
            img = img.resize((self.width, self.height), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr

    asMatrix = as_matrix


NativeImageLoader = ImageLoader   # reference-name alias


class ParentPathLabelGenerator:
    """Label = parent directory name (ref: api.io.labels
    .ParentPathLabelGenerator)."""

    def get_label_for_path(self, path: str) -> str:
        return os.path.basename(os.path.dirname(path))

    getLabelForPath = get_label_for_path


class ImageRecordReader(RecordReader):
    """ref: org.datavec.image.recordreader.ImageRecordReader — each record is
    [NDArrayWritable(image), IntWritable(label)]."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 label_generator=None, transform=None):
        self.loader = ImageLoader(height, width, channels)
        self.label_gen = label_generator
        self.transform = transform
        self._files: List[str] = []
        self._labels: List[str] = []
        self._pos = 0

    def initialize(self, split: FileSplit):
        self._files = split.locations()
        if self.label_gen is not None:
            names = sorted({self.label_gen.get_label_for_path(f)
                            for f in self._files})
            self._labels = names
        self._pos = 0
        return self

    def get_labels(self) -> List[str]:
        return list(self._labels)

    getLabels = get_labels

    def has_next(self):
        return self._pos < len(self._files)

    def next(self):
        path = self._files[self._pos]
        self._pos += 1
        arr = self.loader.as_matrix(path)
        if self.transform is not None:
            arr = self.transform.transform(arr)
        rec = [NDArrayWritable(arr)]
        if self.label_gen is not None:
            rec.append(IntWritable(self._labels.index(
                self.label_gen.get_label_for_path(path))))
        return rec

    def reset(self):
        self._pos = 0


# ------------------------------------------------------------ transforms
class ImageTransform:
    """ref: org.datavec.image.transform.ImageTransform — (H,W,C)→(H,W,C)."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.RandomState(seed)

    def transform(self, image: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ResizeImageTransform(ImageTransform):
    def __init__(self, new_height: int, new_width: int, seed=None):
        super().__init__(seed)
        self.h, self.w = new_height, new_width

    def transform(self, image):
        from PIL import Image
        # float-preserving resize: one PIL 'F'-mode pass per channel, so
        # already-normalized or transformed float inputs are never clipped
        # or quantized through uint8
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 2:
            img = img[..., None]
        chans = [
            np.asarray(Image.fromarray(img[..., c], mode="F")
                       .resize((self.w, self.h), Image.BILINEAR),
                       dtype=np.float32)
            for c in range(img.shape[-1])
        ]
        return np.stack(chans, axis=-1)


class FlipImageTransform(ImageTransform):
    """flip_mode: 0 vertical, 1 horizontal, -1 both, None random
    (ref: FlipImageTransform OpenCV codes)."""

    def __init__(self, flip_mode: Optional[int] = 1, seed=None):
        super().__init__(seed)
        self.mode = flip_mode

    def transform(self, image):
        mode = self.mode
        if mode is None:
            mode = self.rng.choice([-1, 0, 1])
        if mode in (1, -1):
            image = image[:, ::-1]
        if mode in (0, -1):
            image = image[::-1]
        return np.ascontiguousarray(image)


class RotateImageTransform(ImageTransform):
    def __init__(self, angle_deg: float, seed=None):
        super().__init__(seed)
        self.angle = angle_deg

    def transform(self, image):
        from scipy.ndimage import rotate
        return rotate(image, self.angle, axes=(1, 0), reshape=False,
                      order=1, mode="nearest").astype(np.float32)


class CropImageTransform(ImageTransform):
    """Random crop margins up to the given sizes (ref: CropImageTransform)."""

    def __init__(self, crop_top: int, crop_left: int = None,
                 crop_bottom: int = None, crop_right: int = None, seed=None):
        super().__init__(seed)
        self.t = crop_top
        self.l = crop_left if crop_left is not None else crop_top
        self.b = crop_bottom if crop_bottom is not None else crop_top
        self.r = crop_right if crop_right is not None else self.l

    def transform(self, image):
        h, w = image.shape[:2]
        t = self.rng.randint(0, self.t + 1) if self.t else 0
        l = self.rng.randint(0, self.l + 1) if self.l else 0
        b = self.rng.randint(0, self.b + 1) if self.b else 0
        r = self.rng.randint(0, self.r + 1) if self.r else 0
        return np.ascontiguousarray(image[t:h - b or None, l:w - r or None])


class ColorConversionTransform(ImageTransform):
    """Grayscale conversion (the useful subset of the reference's
    OpenCV color-code transform)."""

    def transform(self, image):
        if image.shape[-1] == 1:
            return image
        gray = image @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
        return gray[..., None]


class PipelineImageTransform(ImageTransform):
    """Chain transforms, each applied with a probability
    (ref: PipelineImageTransform)."""

    def __init__(self, transforms: Sequence, probabilities=None, seed=None):
        super().__init__(seed)
        self.transforms = list(transforms)
        self.probs = (list(probabilities) if probabilities
                      else [1.0] * len(self.transforms))

    def transform(self, image):
        for t, p in zip(self.transforms, self.probs):
            if self.rng.rand() <= p:
                image = t.transform(image)
        return image
