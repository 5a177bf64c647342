"""The port's HDF5 reader (``modelimport/hdf5.py``) against ``h5py``, and
the port's HDF5 writer (``tools/keras_h5.py``) read back by ``h5py``.

Every file here is written by ``h5py`` (or by the writer) and read by
both: every group's members, every attribute and every dataset must come
out equal, values, dtypes and shapes, with ``h5py``'s value types (numpy
scalars, ``str`` for variable-length strings, ``'S'`` arrays). The
features the reader refuses raise ``UnsupportedHDF5Feature`` naming
them.
"""
import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu_torch.modelimport import hdf5  # noqa: E402
from deeplearning4j_tpu_torch.tools import keras_h5  # noqa: E402

NUMERIC = ("f2", "f4", "f8", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8")


def _same_value(want, got, where):
    if isinstance(want, h5py.Empty):
        assert isinstance(got, hdf5.Empty), where
        assert got.dtype == want.dtype, where
        return
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (
            where, got.dtype, want.dtype, got.shape, want.shape)
        assert got.tolist() == want.tolist(), where
        if want.dtype.kind not in "OS":
            assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want or (got != got and want != want), (where, got,
                                                              want)


def _agree(path):
    """Walk the file with both readers; the number of objects compared."""
    seen = [0]
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        def walk(w, g, name):
            seen[0] += 1
            assert list(g.attrs) == sorted(w.attrs,
                                           key=lambda s: s.encode()), name
            for k in w.attrs:
                _same_value(w.attrs[k], g.attrs[k], f"{name}@{k}")
            if isinstance(w, h5py.Dataset):
                assert not hasattr(g, "keys"), name
                assert g.shape == w.shape and g.dtype == w.dtype, (
                    name, g.shape, w.shape, g.dtype, w.dtype)
                if w.shape is None:
                    assert isinstance(g[()], hdf5.Empty), name
                    return
                _same_value(w[()], g[()], name)
                if w.shape:
                    _same_value(np.asarray(w), np.asarray(g), name)
                return
            assert not hasattr(g, "shape"), name
            assert list(g) == list(w), name
            for k in w:
                assert k in g, (name, k)
                walk(w[k], g[k], f"{name}/{k}")
        walk(want, got, "")
    return seen[0]


def _fill(f, holder):
    """Every feature of the reader that ``h5py`` writes by default:
    numbers of every width, scalars, empty and unallocated shapes, strings
    both ways, a null dataspace, a boolean, a nested group, a soft link."""
    for dt in NUMERIC:
        holder().create_dataset(
            "d_" + dt, data=(np.arange(12) - 3).reshape(3, 4).astype(dt))
    holder().create_dataset("bool", data=np.array([True, False, True]))
    holder().create_dataset("scalar", data=np.float32(3.5))
    holder().create_dataset("zero", data=np.zeros((0,), "f4"))
    holder().create_dataset("zero2", shape=(3, 0), dtype="f8")
    holder().create_dataset("unallocated", shape=(2, 2), dtype="f4")
    holder().create_dataset("fixed", data=np.array([b"ab", b"cde"]))
    holder().create_dataset("vlen", data=np.array(
        ["ab", "cdé"], dtype=h5py.string_dtype()))
    holder().create_dataset("null", data=h5py.Empty("i4"))
    nested = holder().create_group("nested/deeper")
    nested.attrs["depth"] = 2
    f["soft"] = h5py.SoftLink(nested.name)
    from h5py import h5d, h5p, h5s, h5t
    dcpl = h5p.create(h5p.DATASET_CREATE)
    dcpl.set_layout(h5d.COMPACT)
    ds = h5d.create(f.id, b"compact", h5t.NATIVE_FLOAT, h5s.create_simple(
        (4,)), dcpl=dcpl)
    ds.write(h5s.ALL, h5s.ALL, np.arange(4, dtype="f4"))


def _attrs(target):
    target.attrs["utf8"] = "héllo"
    target.attrs["ascii"] = b"bytes"
    target.attrs["int16"] = np.int16(-3)
    target.attrs["float"] = 2.5
    target.attrs["ints"] = np.arange(5, dtype="i8")
    target.attrs["fixed"] = np.asarray([b"conv1", b"bn", b"a" * 30])
    target.attrs["vlen"] = np.array(["a", "bé", ""],
                                    dtype=h5py.string_dtype())
    target.attrs["empty"] = h5py.Empty("f4")


def test_default_format_every_feature(tmp_path):
    """Superblock v0, v1 headers with continuation blocks (attributes
    added after the groups), symbol-table groups, a 1000-member group (a
    two-level B-tree over 125 SNOD leaves) and a 250 KB variable-length
    attribute (a global heap collection of its own)."""
    path = str(tmp_path / "default.h5")
    with h5py.File(path, "w") as f:
        _attrs(f)
        f.attrs["big"] = "x" * 250_000
        _fill(f, lambda: f)
        many = f.create_group("many")
        for i in range(1000):
            many.create_dataset(f"k{i}:0", data=np.full((2,), i, "f4"))
        for k in range(40):
            f.attrs[f"late{k}"] = k
    with open(path, "rb") as fh:
        assert fh.read(9) == hdf5.SIGNATURE + b"\x00"
    assert _agree(path) > 1000
    with hdf5.File(path) as g:
        assert g.superblock_version == 0
        assert len(g["many"]) == 1000 and len(g.attrs["big"]) == 250_000
        assert "nested/deeper" in g and "soft/deeper" not in g
        assert "nested" in g and "missing" not in g and "many/k999:0" in g
        assert g["soft"].attrs["depth"] == 2
        assert g["/many"]["k7:0"][()].tolist() == [7.0, 7.0]


def test_latest_format(tmp_path):
    """``libver="latest"``: superblock v3, OHDR headers, compact link
    messages and attribute messages v3 (at most 8 members and attributes
    an object: past that HDF5 goes dense, which is refused)."""
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        _attrs(f)
        count = [0]

        def holder():
            count[0] += 1
            return f.require_group(f"h{count[0] // 6}")

        _fill(f, holder)
        f["h0"].attrs["big"] = "y" * 200_000
    assert _agree(path) > 10
    with hdf5.File(path) as g:
        assert g.superblock_version == 3


@pytest.mark.parametrize("make, feature", [
    (lambda f: [f.create_group(f"g{i}") for i in range(20)],
     "dense link storage in a fractal heap"),
    (lambda f: [f.attrs.__setitem__(f"a{i}", i) for i in range(20)],
     "dense attribute storage in a fractal heap"),
    (lambda f: f.create_dataset("c", data=np.ones((10, 10)), chunks=(5, 5)),
     "chunked layouts"),
    (lambda f: f.create_dataset("c", data=np.ones((10, 10)),
                                compression="gzip"), "filter pipelines"),
    (lambda f: f.create_dataset("c", data=np.ones((10,), ">f4")),
     "big-endian types"),
    (lambda f: f.create_dataset("c", data=np.ones((10,), ">i4")),
     "big-endian types"),
    (lambda f: f.create_dataset("c", data=np.zeros((2,), "i4,f8")),
     "compound types"),
], ids=["dense_links", "dense_attributes", "chunked", "filtered",
        "big_endian_float", "big_endian_int", "compound"])
def test_refused_features_raise_typed_errors(tmp_path, make, feature):
    path = str(tmp_path / "refused.h5")
    with h5py.File(path, "w", libver="latest") as f:
        make(f)
    with pytest.raises(hdf5.UnsupportedHDF5Feature) as err:
        with hdf5.File(path) as g:
            def walk(obj):
                dict(obj.attrs)
                if hasattr(obj, "keys"):
                    for k in obj:
                        walk(obj[k])
                else:
                    np.asarray(obj)
            walk(g)
    assert err.value.feature == feature


def test_not_hdf5(tmp_path):
    path = tmp_path / "plain.bin"
    path.write_bytes(b"not an hdf5 file" * 100)
    with pytest.raises(hdf5.HDF5Error):
        hdf5.File(str(path))
    with pytest.raises(ValueError):
        hdf5.File(str(path), "w")


def test_keras_split_attributes(tmp_path):
    """Keras splits an attribute past 64512 bytes into ``name0``,
    ``name1``, ... of fixed-length strings: the writer does as Keras does
    and both readers see the same arrays."""
    path = str(tmp_path / "split.h5")
    root = keras_h5.Group()
    names = [f"layer_with_a_long_name_{i:05d}".encode() for i in range(3000)]
    keras_h5.save_attributes(root, "layer_names", names)
    keras_h5.save_attributes(root.create_group("g"), "weight_names", [])
    keras_h5.write(path, root)
    with h5py.File(path, "r") as f:
        parts = sorted(k for k in f.attrs)
        assert parts == [f"layer_names{i}" for i in range(len(parts))]
        assert len(parts) > 1
        joined = np.concatenate([f.attrs[k] for k in parts])
        assert joined.tolist() == names
    assert _agree(path) == 2


def test_writer_read_back_bit_for_bit(tmp_path):
    """``h5py`` reads the writer's file exactly: numbers of every width,
    a scalar, an empty array, fixed and variable-length strings, a 210 KB
    attribute, 1000 members (a two-level B-tree) and an empty group."""
    path = str(tmp_path / "written.h5")
    rng = np.random.default_rng(0)
    root = keras_h5.Group()
    root.attrs.update({"utf8": "héllo", "ascii": b"bytes",
                       "big": "y" * 210_000, "f": np.float32(1.5),
                       "i": np.int64(-4), "u": np.arange(3, dtype="u2"),
                       "fixed": np.asarray([b"ab", b"cde"]),
                       "vlen": ["a", "bc"], "empty": np.asarray([])})
    arrays = {}
    for dt in NUMERIC:
        a = (rng.standard_normal((3, 5)) * 50).astype(dt)
        arrays[f"d/{dt}"] = a
        root.create_dataset(f"d/{dt}", a).attrs["dtype"] = dt
    arrays["d/scalar"] = np.float64(2.25)
    arrays["d/zero"] = np.zeros((0, 4), "f4")
    root.create_dataset("d/scalar", arrays["d/scalar"])
    root.create_dataset("d/zero", arrays["d/zero"])
    for i in range(1000):
        arrays[f"many/w{i:04d}/kernel"] = np.full((2, 3), i, np.float32)
        root.create_dataset(f"many/w{i:04d}/kernel",
                            arrays[f"many/w{i:04d}/kernel"])
    root.create_group("empty_group")
    keras_h5.write(path, root)
    with h5py.File(path, "r") as f:
        for name, a in arrays.items():
            got = f[name][()]
            assert f[name].dtype == np.asarray(a).dtype, name
            assert np.asarray(got).tobytes() == np.asarray(a).tobytes(), name
        assert f["d/f2"].attrs["dtype"] == "f2"
        assert f.attrs["utf8"] == "héllo" and f.attrs["ascii"] == "bytes"
        assert f.attrs["big"] == "y" * 210_000
        assert f.attrs["fixed"].tolist() == [b"ab", b"cde"]
        assert f.attrs["vlen"].tolist() == ["a", "bc"]
        assert list(f["empty_group"]) == [] and len(f["many"]) == 1000
    assert _agree(path) > 2000


def test_authored_resnet50_and_char_lstm_read_alike(tmp_path):
    """The two authored models read the same through ``h5py`` and the
    reader: every weight, ``model_config``, the name lists."""
    for write in (lambda p: keras_h5.write_resnet50(p, (32, 32, 3), 10),
                  keras_h5.write_char_lstm):
        path = str(tmp_path / "model.h5")
        config = write(path)
        assert _agree(path) > 10
        with hdf5.File(path) as g:
            import json
            assert json.loads(g.attrs["model_config"]) == config
