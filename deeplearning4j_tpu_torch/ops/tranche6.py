"""The registry's sixth tranche: counterparts of the JAX package's
``ops/tranche6.py``, the image-sampling, integer-convolution, unpooling
and generator ops the ONNX importer emits.

- ``grid_sample``: ONNX GridSample (torch ``F.grid_sample`` semantics) as
  the reference writes it, gathers and lerps over NCHW;
- ``max_unpool``: pooled values scattered to their flat argmax positions;
- ``conv_integer``: ONNX ConvInteger, (x − x_zp) * (w − w_zp) exactly
  (the integer product summed in f64, which holds every int32 sum of
  8-bit operands exactly, then rounded back to int32);
- ``lp_pool2d_nchw``: ONNX LpPool, (Σ_window |x|^p)^(1/p), padding
  adding 0;
- ``random_normal_gen`` / ``random_uniform_gen``: ONNX RandomNormal and
  RandomUniform, drawn from ``tranche4.generator_for``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import dtypes as _dt
from deeplearning4j_tpu_torch.ops.registry import register
from deeplearning4j_tpu_torch.ops.tranche4 import generator_for


def _unnormalize(coord, size, align_corners):
    # align_corners=True maps [-1, 1] to [0, size − 1]; False to
    # [-0.5, size − 0.5]
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


@register("grid_sample")
def grid_sample(x, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False):
    """x (N, C, H, W); grid (N, Ho, Wo, 2) of (x, y) in [-1, 1]; returns
    (N, C, Ho, Wo)."""
    n, c, h, w = x.shape
    gx = _unnormalize(grid[..., 0].to(torch.float32), w, align_corners)
    gy = _unnormalize(grid[..., 1].to(torch.float32), h, align_corners)
    flat = x.reshape(n, c, h * w)

    def sample_at(ix, iy):
        if padding_mode == "border":
            valid = torch.ones_like(ix, dtype=torch.bool)
        else:
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ixc, iyc = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
        idx = (iyc * w + ixc).reshape(n, 1, -1).expand(n, c, -1)
        g = torch.gather(flat, 2, idx).reshape((n, c) + tuple(ix.shape[1:]))
        return torch.where(valid[:, None], g, torch.zeros_like(g))

    if mode == "nearest":
        # round half to even, as the reference's jnp.round
        return sample_at(torch.round(gx).to(torch.int64),
                         torch.round(gy).to(torch.int64)).to(x.dtype)
    if mode != "bilinear":
        raise NotImplementedError(f"grid_sample mode {mode!r}")
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    v00 = sample_at(x0i, y0i)
    v01 = sample_at(x0i + 1, y0i)
    v10 = sample_at(x0i, y0i + 1)
    v11 = sample_at(x0i + 1, y0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


@register("max_unpool")
def max_unpool(pooled, indices, output_shape):
    """ONNX MaxUnpool: ``pooled`` written at the flat spatial positions
    ``indices`` (per (N, C) slice) of a zero tensor of ``output_shape``."""
    shape = tuple(int(s) for s in output_shape)
    n, c = shape[0], shape[1]
    spatial = int(np.prod(shape[2:]))
    out = torch.zeros((n, c, spatial), dtype=pooled.dtype,
                      device=pooled.device)
    out = out.scatter(2, indices.long().reshape(n, c, -1),
                      pooled.reshape(n, c, -1))
    return out.reshape(shape)


@register("conv_integer")
def conv_integer(x, w, x_zero_point=0, w_zero_point=0,
                 strides=(1, 1), padding=((0, 0), (0, 0)),
                 dilations=(1, 1)):
    """ONNX ConvInteger over NCHW int8/uint8 ``x`` and (M, C, kH, kW)
    ``w`` with zero points, int32 out."""
    def centred(t, zp):
        zp = zp if isinstance(zp, torch.Tensor) else torch.tensor(zp)
        return t.to(torch.float64) - zp.to(device=t.device,
                                          dtype=torch.float64)

    (t, b), (l, r) = [tuple(int(v) for v in p) for p in padding]
    xi = F.pad(centred(x, x_zero_point), (l, r, t, b))
    out = F.conv2d(xi, centred(w, w_zero_point), None,
                   tuple(int(s) for s in strides), 0,
                   tuple(int(d) for d in dilations))
    return torch.round(out).to(torch.int32)


@register("lp_pool2d_nchw")
def lp_pool2d_nchw(x, kernel, strides=None, padding=((0, 0), (0, 0)),
                   p: float = 2.0):
    """ONNX LpPool (NCHW): (Σ_window |x|^p)^(1/p), in f32."""
    kernel = tuple(int(k) for k in kernel)
    strides = tuple(int(s) for s in strides) if strides else kernel
    (t, b), (l, r) = [tuple(int(v) for v in pp) for pp in padding]
    powed = torch.abs(x.to(torch.float32)) ** p
    summed = F.avg_pool2d(F.pad(powed, (l, r, t, b)), kernel, strides,
                          divisor_override=1)
    return (summed ** (1.0 / p)).to(x.dtype)


def _gen_device(seed, generator):
    gen = generator_for(seed, generator)
    return gen, (gen.device if gen is not None else None)


@register("random_normal_gen")
def random_normal_gen(shape, mean=0.0, scale=1.0, dtype="float32",
                      seed=None, generator=None):
    """ONNX RandomNormal(Like): attribute-shaped normal draws."""
    gen, dev = _gen_device(seed, generator)
    z = torch.randn(tuple(int(s) for s in shape), generator=gen, device=dev)
    return (mean + scale * z).to(_dt.to_torch(dtype))


@register("random_uniform_gen")
def random_uniform_gen(shape, low=0.0, high=1.0, dtype="float32",
                       seed=None, generator=None):
    """ONNX RandomUniform(Like): attribute-shaped uniform draws."""
    gen, dev = _gen_device(seed, generator)
    u = torch.rand(tuple(int(s) for s in shape), generator=gen, device=dev)
    return (u * (high - low) + low).to(_dt.to_torch(dtype))
