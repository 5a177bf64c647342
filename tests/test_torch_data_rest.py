"""The port's normalizers, ``AsyncDataSetIterator``,
``MultipleEpochsIterator`` and the MNIST / CIFAR-10 / EMNIST /
TinyImageNet iterators against the JAX package's on the CPU.

Normalizers: fitted statistics bitwise equal (the same numpy code);
transform and revert of numpy features bitwise, of tensors within atol
1e-6 (torch's f32 elementwise order against numpy's); ``state_dict``
with the reference's keys and values. The iterators hand out the same
batches in the same order, bitwise; the synthetic datasets are the
reference's arrays bit for bit for the same seed, and files in the
standard formats read alike. Every thread the tests start is joined, and
every wait has a timeout.
"""
import gzip
import struct
import threading
import time

import numpy as np
import pytest

import torch

from deeplearning4j_tpu.data import dataset as j_ds
from deeplearning4j_tpu.data import iterators as j_it
from deeplearning4j_tpu.data import mnist as j_mnist
from deeplearning4j_tpu.data import normalizers as j_norm
from deeplearning4j_tpu.data import vision as j_vision
from deeplearning4j_tpu_torch.data import dataset as t_ds
from deeplearning4j_tpu_torch.data import iterators as t_it
from deeplearning4j_tpu_torch.data import mnist as t_mnist
from deeplearning4j_tpu_torch.data import normalizers as t_norm
from deeplearning4j_tpu_torch.data import vision as t_vision

NORM_TENSOR_ATOL = 1e-6
JOIN_S = 10.0


def _features(seed=0, n=24, shape=(5, 4, 3), scale=30.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape) * scale + 7).astype(np.float32)


NORMS = {"standardize": ((), {}), "minmax": ((), {}),
         "minmax_range": ((-1.0, 2.0), {}), "image": ((), {}),
         "image_range": ((-0.5, 0.5, 200.0), {}), "vgg16": ((), {})}
CLASSES = {"standardize": "NormalizerStandardize",
           "minmax": "NormalizerMinMaxScaler",
           "minmax_range": "NormalizerMinMaxScaler",
           "image": "ImagePreProcessingScaler",
           "image_range": "ImagePreProcessingScaler",
           "vgg16": "VGG16ImagePreProcessor"}


def _pair(kind):
    args, kw = NORMS[kind]
    return (getattr(t_norm, CLASSES[kind])(*args, **kw),
            getattr(j_norm, CLASSES[kind])(*args, **kw))


@pytest.mark.parametrize("source", ["dataset", "iterator"])
@pytest.mark.parametrize("kind", sorted(NORMS))
def test_normalizer_matches_reference(kind, source):
    t, j = _pair(kind)
    x = _features(1)
    if kind.startswith("image"):
        x = np.abs(x) % 255
    y = np.zeros((len(x), 2), np.float32)
    if source == "dataset":
        t.fit(t_ds.DataSet(x, y))
        j.fit(j_ds.DataSet(x, y))
    else:
        t.fit(t_it.ArrayDataSetIterator(x, y, 5))
        j.fit(j_it.ArrayDataSetIterator(x, y, 5))
    ts, js = t.state_dict(), j.state_dict()
    assert sorted(ts) == sorted(js)
    for k in js:
        if isinstance(js[k], np.ndarray):
            assert ts[k].dtype == js[k].dtype == np.float32
            np.testing.assert_array_equal(ts[k], js[k])
        else:
            assert ts[k] == js[k], k
    z = _features(2, n=6)
    got = t.transform(t_ds.DataSet(z.copy(), y[:6])).features
    want = j.transform(j_ds.DataSet(z.copy(), y[:6])).features
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_t = t.transform(t_ds.DataSet(torch.as_tensor(z), y[:6])).features
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float32
    np.testing.assert_allclose(got_t.numpy(), want,
                               atol=NORM_TENSOR_ATOL * max(
                                   1.0, float(np.abs(want).max())))
    back = t.revert(t_ds.DataSet(got.copy(), y[:6])).features
    np.testing.assert_array_equal(
        back, j.revert(j_ds.DataSet(want.copy(), y[:6])).features)
    back_t = t.revert(t_ds.DataSet(torch.as_tensor(got), y[:6])).features
    np.testing.assert_allclose(back_t.numpy(), back, rtol=1e-5,
                               atol=NORM_TENSOR_ATOL * 255)
    # a state dict restores across the packages
    fresh = _pair(kind)[0]
    fresh.load_state_dict(js)
    np.testing.assert_array_equal(
        fresh.transform(t_ds.DataSet(z.copy(), y[:6])).features, want)


def test_normalizer_registry_names_the_reference_types():
    assert {k: v.__name__ for k, v in t_norm.NORMALIZERS.items()} == {
        "standardize": "NormalizerStandardize",
        "minmax": "NormalizerMinMaxScaler",
        "image": "ImagePreProcessingScaler",
        "vgg16": "VGG16ImagePreProcessor"}


# -------------------------------------------------------------- iterators
def _batches(it):
    out = []
    while it.has_next():
        ds = it.next()
        out.append((np.asarray(ds.features), np.asarray(ds.labels)))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _xy(n=37, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _async_threads():
    return [t for t in threading.enumerate()
            if t.name == "dl4j-async-iterator"]


@pytest.mark.parametrize("queue_size", [1, 4])
def test_async_iterator_hands_out_the_backing_batches(queue_size):
    x, y = _xy()
    t = t_it.AsyncDataSetIterator(
        t_it.ArrayDataSetIterator(x, y, 8, shuffle=True, seed=5), queue_size)
    j = j_it.AsyncDataSetIterator(
        j_it.ArrayDataSetIterator(x, y, 8, shuffle=True, seed=5), queue_size)
    try:
        for _ in range(3):       # three epochs: reset reshuffles alike
            _assert_same(_batches(t), _batches(j))
            assert t.batch() == 8
            with pytest.raises(StopIteration):
                t.next()
            t.reset()
            j.reset()
        assert len(list(iter(t))) == 5
    finally:
        t.close()
        j.reset()
        j._stop.set()
        j._thread.join(timeout=JOIN_S)
    assert t._thread is None
    deadline = time.monotonic() + JOIN_S
    while _async_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _async_threads()


def test_async_iterator_close_mid_epoch_joins_its_thread():
    x, y = _xy(200)
    it = t_it.AsyncDataSetIterator(t_it.ArrayDataSetIterator(x, y, 2), 2)
    assert it.has_next()
    thread = it._thread
    assert thread.daemon
    it.close()                       # the producer is parked on a full queue
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive()
    it.reset()                       # and a reset starts a new epoch
    assert len(_batches(it)) == 100
    it.close()


class _Failing(t_it.DataSetIterator):
    def __init__(self):
        self.n = 0

    def has_next(self):
        return True

    def next(self):
        self.n += 1
        if self.n == 3:
            raise OSError("corrupt shard")
        return t_ds.DataSet(np.zeros((1, 2)), np.zeros((1, 1)))

    def reset(self):
        self.n = 0

    def batch(self):
        return 1


def test_async_iterator_surfaces_a_backing_error():
    it = t_it.AsyncDataSetIterator(_Failing(), 4)
    try:
        it.next()
        it.next()
        with pytest.raises(OSError, match="corrupt shard"):
            it.next()
        assert not it.has_next()
    finally:
        it.close()


def test_async_iterator_feeds_a_fit_on_the_cpu():
    from deeplearning4j_tpu_torch.nn.conf import configuration as cfg
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optim.updaters import Sgd
    x, y = _xy(32)
    conf = (cfg.NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1))
            .list().layer(L.DenseLayer(n_in=4, n_out=5, activation="tanh"))
            .layer(L.OutputLayer(n_in=5, n_out=3, activation="softmax",
                                 loss_function="mcxent")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    it = t_it.AsyncDataSetIterator(t_it.ArrayDataSetIterator(x, y, 8))
    try:
        net.fit(it, epochs=2)
    finally:
        it.close()
    assert net.getIterationCount() == 8 and net.getEpochCount() == 2


@pytest.mark.parametrize("epochs", [1, 3])
def test_multiple_epochs_iterator_matches_reference(epochs):
    x, y = _xy(20)
    t = t_it.MultipleEpochsIterator(
        epochs, t_it.ArrayDataSetIterator(x, y, 6, shuffle=True, seed=2))
    j = j_it.MultipleEpochsIterator(
        epochs, j_it.ArrayDataSetIterator(x, y, 6, shuffle=True, seed=2))
    got = _batches(t)
    _assert_same(got, _batches(j))
    assert len(got) == 4 * epochs
    t.reset()
    j.reset()
    _assert_same(_batches(t), _batches(j))
    assert t.batch() == 6


# --------------------------------------------------------------- datasets
def test_synthetic_mnist_is_the_reference_bit_for_bit():
    for n, seed in ((64, 0), (50, 7)):
        ti, tl = t_mnist.synthetic_mnist(n, seed)
        ji, jl = j_mnist.synthetic_mnist(n, seed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        assert ti.dtype == ji.dtype == np.float32


@pytest.mark.parametrize("flatten", [True, False])
def test_mnist_iterator_matches_reference(tmp_path, monkeypatch, flatten):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))   # no IDX there
    t = t_mnist.MnistDataSetIterator(32, train=False, num_examples=100,
                                     flatten=flatten)
    j = j_mnist.MnistDataSetIterator(32, train=False, num_examples=100,
                                     flatten=flatten)
    assert t.synthetic and j.synthetic
    _assert_same(_batches(t), _batches(j))


def _write_idx(path, arr, gz=False):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_read_alike(tmp_path, gz):
    base = tmp_path / "mnist"
    base.mkdir()
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (12, 28, 28))
    labels = rng.integers(0, 10, 12)
    sfx = ".gz" if gz else ""
    _write_idx(base / f"t10k-images-idx3-ubyte{sfx}", imgs, gz)
    _write_idx(base / f"t10k-labels-idx1-ubyte{sfx}", labels, gz)
    ti, tl, ts = t_mnist.load_mnist(False, str(tmp_path))
    ji, jl, js = j_mnist.load_mnist(False, str(tmp_path))
    assert not ts and not js
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tl, labels)


@pytest.mark.parametrize("which", ["cifar10", "emnist_letters", "emnist_digits",
                                   "tinyimagenet"])
def test_vision_iterators_match_reference(tmp_path, which):
    kw = dict(num_examples=40, data_dir=str(tmp_path))
    if which == "cifar10":
        t = t_vision.Cifar10DataSetIterator(16, train=False, **kw)
        j = j_vision.Cifar10DataSetIterator(16, train=False, **kw)
    elif which.startswith("emnist"):
        s = which.split("_")[1]
        t = t_vision.EmnistDataSetIterator(s, 16, train=False, **kw)
        j = j_vision.EmnistDataSetIterator(s, 16, train=False, **kw)
        assert t.num_classes() == j.num_classes()
    else:
        t = t_vision.TinyImageNetDataSetIterator(16, train=False,
                                                 num_classes=20, **kw)
        j = j_vision.TinyImageNetDataSetIterator(16, train=False,
                                                 num_classes=20, **kw)
    assert t.synthetic and j.synthetic
    _assert_same(_batches(t), _batches(j))


def test_cifar_binary_batches_read_alike(tmp_path):
    base = tmp_path / "cifar10"
    base.mkdir()
    rng = np.random.default_rng(6)
    rows = np.concatenate([rng.integers(0, 10, (9, 1)),
                           rng.integers(0, 256, (9, 3072))], 1)
    (base / "test_batch.bin").write_bytes(rows.astype(np.uint8).tobytes())
    ti, tl, ts = t_vision.load_cifar10(False, str(tmp_path))
    ji, jl, js = j_vision.load_cifar10(False, str(tmp_path))
    assert not ts and not js
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    assert ti.shape == (9, 32, 32, 3)
