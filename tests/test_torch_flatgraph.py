"""The port's SameDiff persistence (``autodiff/flatgraph.py``: its own
FlatBuffers writer and reader; the zip container) against the JAX
package's, on the CPU: twins of ``tests/test_flatgraph.py``, and files
written by either package loaded by the other.

Across the packages: values bitwise equal; outputs atol 1e-6 (the same
graph on the same values); a resumed fit, its optimizer state carried in
the file, gives the writer's own continuation's losses within 1e-5
relative (the twins' rows). The port's FlatBuffers bytes are also read
by the ``flatbuffers`` package the reference uses.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.autodiff.flatgraph as JF
import deeplearning4j_tpu.autodiff.samediff as J
import deeplearning4j_tpu_torch.autodiff.flatgraph as TF
import deeplearning4j_tpu_torch.autodiff.samediff as T
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.optim import updaters as JU
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.optim import updaters as TU

PKGS = {"jax": (J, JU, JDataSet, {}), "torch": (T, TU, TDataSet,
                                                {"device": "cpu"})}


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def create(pkg):
    mod, _u, _d, kw = PKGS[pkg]
    return mod.SameDiff.create(**kw)


def load(pkg, path):
    mod, _u, _d, kw = PKGS[pkg]
    return mod.SameDiff.load(path, **kw)


def linear_sd(pkg):
    sd = create(pkg)
    x = sd.placeholder("x", (None, 3), np.float32)
    w = sd.var("w", init=np.arange(6, dtype=np.float32).reshape(3, 2) * 0.1)
    b = sd.var("b", init=np.zeros(2, np.float32))
    (x.mmul(w) + b).rename("y")
    return sd


def trained(pkg, steps=6):
    mod, upd, ds_cls, _kw = PKGS[pkg]
    sd = linear_sd(pkg)
    lab = sd.placeholder("label", (None, 2), np.float32)
    sd.loss.mse(lab, sd._vars["y"]).rename("loss")
    sd.set_training_config(mod.TrainingConfig(
        updater=upd.Adam(0.05), data_set_feature_mapping=["x"],
        data_set_label_mapping=["label"], loss_variables=["loss"]))
    rng = np.random.default_rng(7)
    X = rng.normal(size=(32, 3)).astype(np.float32)
    W = np.array([[1.0, -1.0], [0.5, 2.0], [-0.3, 0.7]], np.float32)
    ds = ds_cls(X, X @ W)
    sd.fit([ds] * steps, epochs=1)
    return sd, ds


# ------------------------------------------------------------ round trip
def test_linear_exec_parity():
    sd = linear_sd("torch")
    data = sd.as_flat_buffers()
    assert isinstance(data, bytes) and len(data) > 100
    sd2 = T.SameDiff.from_flat_buffers(data, device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_(sd2.output({"x": x}, ["y"])["y"]),
                                  np_(sd.output({"x": x}, ["y"])["y"]))


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_attr_kinds_survive(reader):
    sd = create("torch")
    x = sd.placeholder("x", (2, 3, 4, 1), np.float32)
    sd._op("pad", x, paddings=((0, 0), (1, 2), (0, 1), (0, 0)),
           mode="CONSTANT", constant_values=1.5).rename("p")
    sd._op("cumsum", sd._vars["p"], axis=1, exclusive=True,
           reverse=False).rename("c")
    sd._op("cast", sd._vars["c"], dtype="int32").rename("i")
    data = sd.as_flat_buffers()
    sd2 = (T.SameDiff.from_flat_buffers(data, device="cpu")
           if reader == "torch" else J.SameDiff.from_flat_buffers(data))
    ops = {o.op_name: o for o in sd2._ops}
    assert ops["pad"].attrs["paddings"] == ((0, 0), (1, 2), (0, 1), (0, 0))
    assert ops["pad"].attrs["mode"] == "CONSTANT"
    assert ops["pad"].attrs["constant_values"] == 1.5
    assert ops["cumsum"].attrs == {"axis": 1, "exclusive": True,
                                   "reverse": False}
    x_np = np.random.default_rng(1).normal(size=(2, 3, 4, 1)).astype(
        np.float32)
    np.testing.assert_allclose(np_(sd2.output({"x": x_np}, ["c"])["c"]),
                               np_(sd.output({"x": x_np}, ["c"])["c"]),
                               atol=1e-6)


def test_training_state_survives_and_fine_tunes(tmp_path):
    sd, ds = trained("torch", steps=20)
    p = str(tmp_path / "model.fb")
    sd.save(p)
    sd2 = T.SameDiff.load(p, device="cpu")
    np.testing.assert_array_equal(np_(sd2._values["w"]), np_(sd._values["w"]))
    assert sd2._loss_variables == ["loss"]
    assert sd2.training_config is not None
    h = sd2.fit([ds] * 20, epochs=3)
    assert h[-1] < h[0] or h[0] < 1e-3


def test_scalar_shape_and_name_counter_survive():
    sd = linear_sd("torch")
    sd.var("scale", init=np.float32(2.0))
    sd2 = T.SameDiff.from_flat_buffers(sd.as_flat_buffers(), device="cpu")
    assert sd2._vars["scale"].shape == ()
    before = set(sd2._vars)
    v = sd2._op("add", sd2._vars["y"], sd2._vars["scale"])
    assert v.name not in before


def test_load_diagnosable_on_garbage_file(tmp_path):
    p = str(tmp_path / "junk.model")
    with open(p, "wb") as f:
        f.write(b"definitely not a graph")
    with pytest.raises(ValueError, match="neither a SameDiff zip"):
        T.SameDiff.load(p, device="cpu")


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_control_flow_roundtrips_as_scoped_regions(reader):
    sd = create("torch")
    x = sd.placeholder("x", (2,), np.float32)
    i0 = sd.constant(np.int32(0), name="i0")
    out = sd.while_loop(
        lambda s, i, a: s._op("less", i, s.constant(np.int32(4))),
        lambda s, i, a: [s._op("add", i, s.constant(np.int32(1))),
                         s._op("mul", a, s.constant(np.float32(2.0)))],
        i0, x)
    out[1].rename("doubled")
    data = sd.as_flat_buffers()
    sd2 = (T.SameDiff.from_flat_buffers(data, device="cpu")
           if reader == "torch" else J.SameDiff.from_flat_buffers(data))
    xv = np.array([1.5, -3.0], np.float32)
    a = np_(sd.output({"x": xv}, ["doubled"])["doubled"])
    np.testing.assert_allclose(a, xv * 16)
    np.testing.assert_allclose(np_(sd2.output({"x": xv}, ["doubled"])
                                   ["doubled"]), a)


def test_lambda_op_refuses_loudly():
    sd = linear_sd("torch")
    sd.lambda_op(torch.tanh, sd._vars["y"])
    with pytest.raises(ValueError, match="lambda"):
        sd.as_flat_buffers()


# ------------------------------------------------------- schema and codec
def test_flatbuffers_package_reads_the_port_bytes():
    """What a foreign reader relies on, read through the ``flatbuffers``
    runtime (the reference's ``_Tab``): offsets resolve, vectors have the
    right arity, FlatArray payloads decode to the values."""
    sd = linear_sd("torch")
    data = sd.as_flat_buffers()
    import flatbuffers
    from flatbuffers import number_types as NT

    buf = bytearray(data)
    root = flatbuffers.encode.Get(NT.UOffsetTFlags.packer_type, buf, 0)
    g = JF._Tab(buf, root)
    vars_ = g.table_vec(JF._FG["variables"])
    nodes = g.table_vec(JF._FG["nodes"])
    assert len(vars_) == len(sd._vars) and len(nodes) == len(sd._ops)
    assert {"x", "w", "b", "y"} <= {v.string(JF._FV["name"]) for v in vars_}
    assert g.string_vec(JF._FG["placeholders"]) == ["x"]
    for v in vars_:
        if v.string(JF._FV["name"]) == "w":
            arr = JF._read_flat_array(v.table(JF._FV["ndarray"]))
            np.testing.assert_array_equal(
                arr, np.arange(6, dtype=np.float32).reshape(3, 2) * 0.1)
    for n in nodes:
        assert n.string(JF._FN["opName"])
        assert n.i8(JF._FN["opType"]) == TF._OP_TYPE_CUSTOM


def test_dtype_codes_and_shape_info_are_the_reference_values():
    for dt in (np.float32, np.float64, np.int32, np.int64, np.bool_,
               np.int8, np.uint8, np.float16):
        assert TF._NP_TO_DTYPE[np.dtype(dt)] == JF._NP_TO_DTYPE[np.dtype(dt)]
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    assert list(TF._shape_info(a.shape)) == list(JF._shape_info(a.shape))
    for vec, n in ((TF._shape_info(a.shape), 24), (np.asarray([2, 3, 4]), 24),
                   (TF._shape_info(()), 1),
                   (np.asarray([3, 2, 2, 2, 2, 1, 1, 1, 1, 1]), 48),
                   (np.asarray([2, 2, 3, 1, 2, 0, 1, ord("f")]), 6)):
        assert TF._decode_shape(vec, n) == JF._decode_shape(vec, n)


def test_bfloat16_values_round_trip():
    sd = create("torch")
    v = torch.randn(3, 4).to(torch.bfloat16)
    sd.constant(v, name="h")
    sd2 = T.SameDiff.from_flat_buffers(sd.as_flat_buffers(), device="cpu")
    assert sd2._values["h"].dtype == torch.bfloat16
    assert torch.equal(sd2._values["h"], v)


def test_legacy_enum_op_registration_path():
    """A node with no opName and an (opType, opNum) pair loads once the
    pair is registered; unregistered, it refuses with instructions."""
    node = TF._Table([
        (TF._FN["id"], "i32", 1), (TF._FN["name"], "off", TF._Str("n")),
        (TF._FN["opType"], "i8", 3), (TF._FN["opNum"], "i64", 42),
        (TF._FN["inputPaired"], "off", TF._Vec([TF._int_pair(2, 0)])),
        (TF._FN["outputNames"], "off", TF._strings(["y"]))])
    var = TF._Table([
        (TF._FV["id"], "off", TF._int_pair(2, 0)),
        (TF._FV["name"], "off", TF._Str("x")), (TF._FV["dtype"], "i8", 5),
        (TF._FV["variabletype"], "i8", 3)])
    legacy = TF._Writer().finish(TF._Table([
        (TF._FG["variables"], "off", TF._Vec([var])),
        (TF._FG["nodes"], "off", TF._Vec([node]))]))
    with pytest.raises(ValueError, match="register_legacy_op"):
        TF.from_flat_buffers(legacy, device="cpu")
    TF.register_legacy_op(3, 42, "tanh")
    try:
        sd2 = TF.from_flat_buffers(legacy, device="cpu")
        x = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
        np.testing.assert_allclose(np_(sd2.output({"x": x}, ["y"])["y"]),
                                   np.tanh(x), atol=1e-6)
    finally:
        TF._LEGACY_OPS.pop((3, 42), None)


# ---------------------------------------------------------- updater state
def test_resume_identical_to_uninterrupted(tmp_path):
    sd, ds = trained("torch")
    p = str(tmp_path / "ckpt.fb")
    sd.save(p, save_updater_state=True)
    uninterrupted = sd.fit([ds] * 5, epochs=1)
    sd2 = T.SameDiff.load(p, device="cpu")
    assert sd2._pending_opt_named is not None
    np.testing.assert_allclose(list(sd2.fit([ds] * 5, epochs=1)),
                               list(uninterrupted), rtol=1e-5)


def test_without_state_restarts_moments(tmp_path):
    sd, ds = trained("torch")
    p = str(tmp_path / "ckpt.fb")
    sd.save(p)
    uninterrupted = sd.fit([ds] * 5, epochs=1)
    sd2 = T.SameDiff.load(p, device="cpu")
    assert sd2._pending_opt_named is None
    assert not np.allclose(list(sd2.fit([ds] * 5, epochs=1)),
                           list(uninterrupted), rtol=1e-6)


def test_mismatched_updater_falls_back_fresh(tmp_path):
    sd, ds = trained("torch")
    p = str(tmp_path / "ckpt.fb")
    sd.save(p, save_updater_state=True)
    sd2 = T.SameDiff.load(p, device="cpu")
    sd2.training_config.updater = TU.RmsProp(0.05)
    with pytest.warns(UserWarning, match="updaterState"):
        h = sd2.fit([ds] * 2, epochs=1)
    assert np.isfinite(h[-1])


@pytest.mark.parametrize("first, second", [(".fb", ".fb"), (".fb", ".sdz")])
def test_resave_without_refit_keeps_state(tmp_path, first, second):
    sd, ds = trained("torch")
    p1 = str(tmp_path / f"a{first}")
    sd.save(p1, save_updater_state=True)
    uninterrupted = sd.fit([ds] * 4, epochs=1)
    mid = T.SameDiff.load(p1, device="cpu")
    p2 = str(tmp_path / f"b{second}")
    mid.save(p2, save_updater_state=True)
    sd2 = T.SameDiff.load(p2, device="cpu")
    np.testing.assert_allclose(list(sd2.fit([ds] * 4, epochs=1)),
                               list(uninterrupted), rtol=1e-5)


# --------------------------------------------------------- across packages
@pytest.mark.parametrize("ext", [".fb", ".sdz"])
@pytest.mark.parametrize("writer, reader", [("jax", "torch"),
                                            ("torch", "jax")])
def test_files_cross_the_packages(tmp_path, ext, writer, reader):
    """A trained graph with its Adam state, written by one package, loads
    in the other: values bitwise, outputs equal, and the resumed fit
    gives the writer's own continuation."""
    sd, ds = trained(writer)
    p = str(tmp_path / f"model{ext}")
    sd.save(p, save_updater_state=True)
    other = load(reader, p)
    for n in ("w", "b"):
        a, b = np_(sd._values[n]), np_(other._values[n])
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    x = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(other.output({"x": x}, "y")["y"]),
                               np_(sd.output({"x": x}, "y")["y"]), atol=1e-6)
    X, Y = np_(ds.features), np_(ds.labels)
    uninterrupted = sd.fit([ds] * 4, epochs=1)
    resumed = other.fit([PKGS[reader][2](X, Y)] * 4, epochs=1)
    np.testing.assert_allclose(list(resumed), list(uninterrupted),
                               rtol=1e-5)


def test_zip_updater_leaves_are_bitwise_the_references(tmp_path):
    """The port's updater.npz holds the reference's optax leaves in its
    order: the same steps give the same leaf dtypes and shapes, and the
    values to the twins' param row."""
    import zipfile

    leaves = {}
    for pkg in ("jax", "torch"):
        sd, _ = trained(pkg)
        p = str(tmp_path / f"{pkg}.sdz")
        sd.save(p, save_updater_state=True)
        with zipfile.ZipFile(p) as zf:
            raw = np.load(__import__("io").BytesIO(zf.read("updater.npz")))
            leaves[pkg] = [raw[f"leaf{i}"] for i in range(len(raw.files))]
    assert len(leaves["jax"]) == len(leaves["torch"])
    for a, b in zip(leaves["jax"], leaves["torch"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-6)


def test_imported_mini_bert_crosses_as_flatgraph(tmp_path):
    """The tests' mini BERT (its skeleton filled from a seed), imported by
    the port and given a head, saved as a FlatGraph: the JAX package
    loads it and computes the same loss, and the port reloads it and
    fine-tunes."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.modelimport import tf_skeleton
    from deeplearning4j_tpu_torch.modelimport.tfimport import TFGraphMapper
    from tests._torch_bert import attach_head, promote

    gd = tf_skeleton.fill_skeleton(tf_skeleton.load_skeleton(
        "bert_mini_b2_t8"), seed=5)
    sd = TFGraphMapper.import_graph(gd, device="cpu")
    promote(sd, 64)
    attach_head(T, TU, sd, gd)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 2)]
    feed = {"input_ids": ids, "attention_mask": mask, "label": y}
    ref = float(sd.output(feed, ["loss"])["loss"])
    p = str(tmp_path / "bert_mini.fb")
    sd.save(p)
    assert abs(float(np.asarray(J.SameDiff.load(p).output(
        feed, ["loss"])["loss"])) - ref) < 1e-5
    sd2 = T.SameDiff.load(p, device="cpu")
    assert abs(float(sd2.output(feed, ["loss"])["loss"]) - ref) < 1e-6
    losses = sd2.fit([MultiDataSet([ids, mask], [y])] * 3)
    assert np.isfinite(losses).all()
