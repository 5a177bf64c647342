"""The YOLOv2 detection head: counterpart of
``deeplearning4j_tpu/nn/conf/objdetect.py`` (the reference's
``Yolo2OutputLayer``, ``DetectedObject`` and ``YoloUtils``).

Labels are NHWC (N, H, W, 4 + C): per grid cell the box x1, y1, x2, y2 in
grid units, then the class one-hot; a cell holds an object where its
one-hot is not zero. The loss is elementwise torch over (N, H, W, B, 5 +
C): the responsible anchor, the coordinate, confidence and class terms,
with no loop over cells.

As the reference: every max and min is ``torch.maximum`` /
``torch.minimum`` against a tensor, which at a tie sends half the gradient
each way as ``jnp.maximum`` does (``clamp`` would send all of it one way);
``torch.argmax`` over the anchors takes the first maximum, as
``jnp.argmax``; and the confidence target, the predicted box's IoU with
the label, is not detached. Detection (``get_predicted_objects``,
``non_max_suppression``) runs on the host over the activations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, register_layer


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _box_iou_wh(wh1, wh2):
    """IoU of two boxes that share a center; inputs broadcast (..., 2)."""
    inter = (torch.minimum(wh1[..., 0], wh2[..., 0])
             * torch.minimum(wh1[..., 1], wh2[..., 1]))
    a1 = wh1[..., 0] * wh1[..., 1]
    a2 = wh2[..., 0] * wh2[..., 1]
    return inter / torch.maximum(a1 + a2 - inter, _const(1e-9, inter))


def box_iou_xyxy(b1, b2):
    """IoU of (..., 4) boxes given as x1, y1, x2, y2."""
    zero = _const(0.0, b1)
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = torch.maximum(x2 - x1, zero) * torch.maximum(y2 - y1, zero)
    a1 = (torch.maximum(b1[..., 2] - b1[..., 0], zero)
          * torch.maximum(b1[..., 3] - b1[..., 1], zero))
    a2 = (torch.maximum(b2[..., 2] - b2[..., 0], zero)
          * torch.maximum(b2[..., 3] - b2[..., 1], zero))
    return inter / torch.maximum(a1 + a2 - inter, _const(1e-9, inter))


def _grid(h, w, like):
    """(cy, cx) cell indices, each (H, W)."""
    return torch.meshgrid(
        torch.arange(h, dtype=like.dtype, device=like.device),
        torch.arange(w, dtype=like.dtype, device=like.device), indexing="ij")


@register_layer
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection loss (the reference's ``computeScore``).

    ``boxes``: (B, 2) anchor priors (w, h) in grid units. Input
    activations: (N, H, W, B·(5 + C))."""
    boxes: Optional[Sequence[Tuple[float, float]]] = None
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def __post_init__(self):
        if self.boxes is not None:
            self.boxes = tuple(tuple(float(v) for v in b) for b in self.boxes)

    @property
    def n_boxes(self) -> int:
        return len(self.boxes)

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _split(self, x):
        """(N, H, W, B·(5 + C)) → tx, ty, tw, th, tc (N, H, W, B) each and
        the class logits (N, H, W, B, C)."""
        n, h, w, d = x.shape
        b = self.n_boxes
        x = x.reshape(n, h, w, b, d // b)
        return x[..., 0], x[..., 1], x[..., 2], x[..., 3], x[..., 4], x[..., 5:]

    def _anchors(self, like):
        return torch.tensor(self.boxes, dtype=like.dtype, device=like.device)

    def activate_detections(self, x):
        """The decoded predictions in grid units: (xy (N, H, W, B, 2), wh
        (N, H, W, B, 2), conf (N, H, W, B), prob (N, H, W, B, C)): sigmoid
        of the offsets and the confidence, exp(t)·anchor for the sizes,
        softmax over the classes (``YoloUtils#activate``)."""
        tx, ty, tw, th, tc, cls = self._split(x)
        n, h, w, b = tx.shape
        cy, cx = _grid(h, w, x)
        px = torch.sigmoid(tx) + cx[None, :, :, None]
        py = torch.sigmoid(ty) + cy[None, :, :, None]
        anchors = self._anchors(x)
        pw = torch.exp(tw) * anchors[:, 0]
        ph = torch.exp(th) * anchors[:, 1]
        conf = torch.sigmoid(tc)
        prob = torch.exp(cls - torch.amax(cls, dim=-1, keepdim=True))
        prob = prob / torch.sum(prob, dim=-1, keepdim=True)
        return (torch.stack([px, py], -1), torch.stack([pw, ph], -1), conf,
                prob)

    def apply(self, params, x, training=False, gen=None, state=None):
        return x, state

    def loss(self, params, x, labels, mask=None, training=False, gen=None,
             state=None):
        tx = self._split(x)[0]
        n, h, w, b = tx.shape
        labels = labels.to(x.dtype)
        lb = labels[..., :4]                               # x1, y1, x2, y2
        lcls = labels[..., 4:]                             # (N, H, W, C)
        obj = (torch.sum(lcls, dim=-1) > 0).to(x.dtype)    # (N, H, W)
        zero = _const(0.0, x)

        gt_w = lb[..., 2] - lb[..., 0]
        gt_h = lb[..., 3] - lb[..., 1]
        gt_cx = 0.5 * (lb[..., 0] + lb[..., 2])
        gt_cy = 0.5 * (lb[..., 1] + lb[..., 3])

        # the responsible anchor of each object cell: the prior whose (w, h)
        # has the largest IoU with the label's size, the first on a tie
        iou_prior = _box_iou_wh(self._anchors(x)[None, None, None],
                                torch.stack([gt_w, gt_h], -1)[..., None, :])
        resp = torch.argmax(iou_prior, dim=-1)              # (N, H, W)
        resp_1h = (resp[..., None] == torch.arange(b, device=x.device)).to(
            x.dtype)
        resp_mask = resp_1h * obj[..., None]

        xy, wh, conf, prob = self.activate_detections(x)
        cy, cx = _grid(h, w, x)

        # coordinates: the sigmoid offsets and the square roots of the sizes
        px_off = xy[..., 0] - cx[None, :, :, None]
        py_off = xy[..., 1] - cy[None, :, :, None]
        gx_off = (gt_cx - cx[None])[..., None]
        gy_off = (gt_cy - cy[None])[..., None]
        floor = _const(1e-9, x)
        coord = (px_off - gx_off) ** 2 + (py_off - gy_off) ** 2
        coord = coord + (torch.sqrt(torch.maximum(wh[..., 0], floor))
                         - torch.sqrt(torch.maximum(gt_w, zero))[..., None]) ** 2
        coord = coord + (torch.sqrt(torch.maximum(wh[..., 1], floor))
                         - torch.sqrt(torch.maximum(gt_h, zero))[..., None]) ** 2
        coord_loss = self.lambda_coord * torch.sum(coord * resp_mask)

        # confidence: the target is the predicted box's IoU with the label
        # for responsible anchors (differentiated, as the reference does),
        # 0 elsewhere
        pred_xyxy = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
        iou = box_iou_xyxy(pred_xyxy, lb[..., None, :])
        conf_obj = torch.sum(((conf - iou) ** 2) * resp_mask)
        conf_noobj = self.lambda_no_obj * torch.sum((conf ** 2)
                                                    * (1.0 - resp_mask))

        # classes: squared error of the softmax probabilities
        cls_loss = torch.sum(((prob - lcls[..., None, :]) ** 2)
                             * resp_mask[..., None])
        return (coord_loss + conf_obj + conf_noobj + cls_loss) / n


# --------------------------------------------------------------- inference
@dataclasses.dataclass
class DetectedObject:
    """One detection (the reference's ``DetectedObject``), grid units."""
    example: int
    center_x: float
    center_y: float
    width: float
    height: float
    predicted_class: int
    confidence: float

    def top_left(self):
        return (self.center_x - self.width / 2,
                self.center_y - self.height / 2)

    def bottom_right(self):
        return (self.center_x + self.width / 2,
                self.center_y + self.height / 2)


def get_predicted_objects(layer: Yolo2OutputLayer, activations,
                          threshold: float = 0.5):
    """The decoded detections whose confidence exceeds ``threshold``
    (``YoloUtils#getPredictedObjects``), in (example, row, column, anchor)
    order. The decode runs where the activations are; the filter on the
    host."""
    if not isinstance(activations, torch.Tensor):
        activations = torch.as_tensor(np.asarray(activations))
    with torch.no_grad():
        xy, wh, conf, prob = (v.float().cpu().numpy() for v in
                              layer.activate_detections(activations))
    out = []
    for ex in range(conf.shape[0]):
        for (i, j, k) in np.argwhere(conf[ex] > threshold):
            out.append(DetectedObject(
                ex, float(xy[ex, i, j, k, 0]), float(xy[ex, i, j, k, 1]),
                float(wh[ex, i, j, k, 0]), float(wh[ex, i, j, k, 1]),
                int(np.argmax(prob[ex, i, j, k])), float(conf[ex, i, j, k])))
    return out


def _iou_host(a, b):
    """``box_iou_xyxy`` of two (4,) boxes in f32, on the host."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    x1, y1 = np.maximum(a[0], b[0]), np.maximum(a[1], b[1])
    x2, y2 = np.minimum(a[2], b[2]), np.minimum(a[3], b[3])
    inter = np.float32(max(x2 - x1, 0.0)) * np.float32(max(y2 - y1, 0.0))
    a1 = np.float32(max(a[2] - a[0], 0.0)) * np.float32(max(a[3] - a[1], 0.0))
    a2 = np.float32(max(b[2] - b[0], 0.0)) * np.float32(max(b[3] - b[1], 0.0))
    return float(inter / np.float32(max(a1 + a2 - inter, np.float32(1e-9))))


def non_max_suppression(objects, iou_threshold: float = 0.45):
    """Greedy NMS per (example, class) (``YoloUtils#nms``): the most
    confident box of a group stays, and every box overlapping it by an IoU
    of ``iou_threshold`` or more goes."""
    kept = []
    by_key = {}
    for o in objects:
        by_key.setdefault((o.example, o.predicted_class), []).append(o)
    for group in by_key.values():
        group = sorted(group, key=lambda o: -o.confidence)
        while group:
            best = group.pop(0)
            kept.append(best)
            bx = (*best.top_left(), *best.bottom_right())
            group = [o for o in group
                     if _iou_host(bx, (*o.top_left(), *o.bottom_right()))
                     < iou_threshold]
    return kept
