"""The port's ``SDBitwise`` and ``SDImage`` namespaces against the JAX
package's, on the CPU: each method builds the same one-op graph in both
packages over the same seeded constants, and the outputs agree (integers
exactly; f32 at atol 1e-5, the image ops' sums in another order). Also a
graph whose drawing op takes the generator the engine hands it: the same
draw on every run, another under another seed.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import samediff as J
from deeplearning4j_tpu_torch.autodiff import samediff as T


def _ints(seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, (2, 5)).astype(dtype)


def _img(seed, shape=(1, 6, 7, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


BOXES = np.array([[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.0, 0.5]], np.float32)
IDX = np.array([0, 0], np.int32)

CASES = [
    ("bitwise", "and_", lambda: [_ints(1), _ints(2)], {}),
    ("bitwise", "or_", lambda: [_ints(3), _ints(4)], {}),
    ("bitwise", "xor", lambda: [_ints(5), _ints(6)], {}),
    ("bitwise", "bitwiseAnd", lambda: [_ints(7, np.int8), _ints(8, np.int8)],
     {}),
    ("bitwise", "left_shift", lambda: [_ints(9), np.full((2, 5), 3,
                                                         np.int32)], {}),
    ("bitwise", "right_shift", lambda: [_ints(10), np.full((2, 5), 2,
                                                           np.int32)], {}),
    ("bitwise", "left_shift_cyclic", lambda: [_ints(11), np.full(
        (2, 5), 5, np.int32)], {}),
    ("bitwise", "bits_hamming_distance", lambda: [_ints(12), _ints(13)], {}),
    ("image", "resize_bilinear", lambda: [_img(1)], {"h": 9, "w": 4}),
    ("image", "resize_nearest", lambda: [_img(2)], {"h": 9, "w": 4}),
    ("image", "resize_bicubic", lambda: [_img(3)], {"h": 9, "w": 4}),
    ("image", "crop_and_resize", lambda: [_img(4, (2, 6, 7, 3)), BOXES, IDX],
     {"crop_h": 3, "crop_w": 4}),
    ("image", "extract_image_patches", lambda: [_img(5)],
     {"kh": 2, "kw": 3, "sh": 2, "sw": 1, "same_mode": True}),
    ("image", "rgb_to_hsv", lambda: [_img(6)], {}),
    ("image", "hsv_to_rgb", lambda: [_img(7)], {}),
    ("image", "rgb_to_yuv", lambda: [_img(8)], {}),
    ("image", "yuv_to_rgb", lambda: [_img(9)], {}),
    ("image", "adjust_contrast", lambda: [_img(10), np.float32(1.5)], {}),
    ("image", "adjust_saturation", lambda: [_img(11), np.float32(0.5)], {}),
    ("image", "adjust_hue", lambda: [_img(12), np.float32(0.25)], {}),
    ("image", "non_max_suppression", lambda: [
        np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, 2, 1, 3]], np.float32),
        np.array([0.9, 0.8, 0.7], np.float32)], {"max_out": 2}),
]


def _build(pkg, space, method, arrays, kw):
    sd = pkg.SameDiff.create(**({"device": "cpu"} if pkg is T else {}))
    ins = [sd.constant(a) for a in arrays]
    out = getattr(getattr(sd, space), method)(*ins, **kw)
    out.rename("out")
    return np.asarray(_np(sd.output({}, "out")["out"]))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}.{c[1]}" for c in CASES])
def test_namespace_method_matches_reference(case):
    space, method, make, kw = case
    arrays = make()
    got = _build(T, space, method, arrays, kw)
    want = _build(J, space, method, arrays, kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_drawing_op_in_a_graph_takes_the_engines_generator():
    sd = T.SameDiff.create("cpu")
    sd._op("random_normal_gen", shape=[2000], mean=1.0, scale=2.0).rename(
        "rn")
    a = _np(sd.output({}, "rn")["rn"])
    np.testing.assert_array_equal(_np(sd.output({}, "rn")["rn"]), a)
    b = _np(sd.output({}, "rn", rng_seed=7)["rn"])
    assert not np.array_equal(a, b)
    for draw in (a, b):
        assert abs(draw.mean() - 1.0) < 0.15 and abs(draw.std() - 2.0) < 0.15
    seeded = T.SameDiff.create("cpu")
    seeded._op("random_normal_gen", shape=[2000], seed=11).rename("rn")
    np.testing.assert_array_equal(
        _np(seeded.output({}, "rn")["rn"]),
        _np(seeded.output({}, "rn", rng_seed=7)["rn"]))
