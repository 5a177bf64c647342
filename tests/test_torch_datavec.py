"""The port's DataVec (``deeplearning4j_tpu_torch/datavec/``), its
record-reader DataSet iterators (``data/record_reader_iterator.py``) and
its resource cache (``utils/resources.py``) against the JAX package's,
on the CPU.

Twins of the 20 tests of ``tests/test_datavec.py`` and of the Arrow
bridge's cases in ``tests/test_interop_arrow.py``: each body runs once
with each package's modules, makes the reference test's assertions, and
returns what it read; the two returns must be equal: every record's
Writables (their types and values), transform outputs and schemas, and
the iterators' features, labels and masks (dtypes, shapes and values).
The CSV end-to-end case then trains the port's MultiLayerNetwork on the
port's iterator.
"""
import hashlib
import importlib
import os
import types

import numpy as np
import pytest

MODULES = ("datavec", "datavec.records", "datavec.transform",
           "datavec.writable", "datavec.schema", "datavec.image",
           "datavec.arrow", "datavec.local", "datavec.distributed",
           "data.record_reader_iterator", "data.dataset", "utils.resources")


def _package(root):
    ns = types.SimpleNamespace(root=root)
    for name in MODULES:
        setattr(ns, name.split(".")[-1], importlib.import_module(
            f"{root}.{name}"))
    return ns


REF = _package("deeplearning4j_tpu")
PORT = _package("deeplearning4j_tpu_torch")


def _plain(x):
    """What a body returned, as plain comparable values: a Writable as
    (its class name, its value), an array as (dtype, shape, values), a
    DataSet as its four fields."""
    if isinstance(x, (REF.writable.Writable, PORT.writable.Writable)):
        return (type(x).__name__, _plain(x.value))
    if hasattr(x, "features") and hasattr(x, "labels_mask"):
        return ("DataSet", _plain(x.features), _plain(x.labels),
                _plain(x.features_mask), _plain(x.labels_mask))
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (np.generic,)):
        return (type(x).__name__, x.item())
    return x


def twin(body, tmp_path=None, **kw):
    """``body(P, ...)`` with each package; their returns must be equal."""
    got = {}
    for P in (REF, PORT):
        if tmp_path is not None:
            d = tmp_path / P.root
            d.mkdir()
            kw["tmp_path"] = d
        got[P.root] = _plain(body(P, **kw))
    assert got["deeplearning4j_tpu_torch"] == got["deeplearning4j_tpu"]
    return got["deeplearning4j_tpu_torch"]


def _rows(reader):
    return [list(r) for r in reader]


# ---------------------------------------------------- tests/test_datavec.py
def test_csv_record_reader(tmp_path):
    def body(P, tmp_path):
        p = tmp_path / "data.csv"
        p.write_text("# header\n1,2.5,hello\n3,4.0,world\n")
        rr = P.datavec.CSVRecordReader(skip_num_lines=1).initialize(
            P.datavec.FileSplit(str(p)))
        rows = list(rr)
        assert len(rows) == 2
        assert isinstance(rows[0][0], P.writable.IntWritable)
        assert rows[0][0].value == 1
        assert isinstance(rows[0][1], P.writable.DoubleWritable)
        assert rows[0][1].value == 2.5
        assert isinstance(rows[0][2], P.writable.Text)
        assert rows[0][2].value == "hello"
        rr.reset()
        assert rr.has_next()
        return rows + _rows(rr)
    twin(body, tmp_path)


def test_line_record_reader():
    def body(P):
        rr = P.datavec.LineRecordReader().initialize(
            P.records.StringSplit("a\nb\nc"))
        rows = _rows(rr)
        assert [r[0].value for r in rows] == ["a", "b", "c"]
        return rows
    twin(body)


def _schema3(P):
    return (P.datavec.Schema.Builder()
            .add_column_integer("id")
            .add_column_double("value")
            .add_column_categorical("cat", "A", "B", "C")
            .build())


def test_schema_builder():
    def body(P):
        schema = _schema3(P)
        assert schema.num_columns() == 3
        assert schema.get_index_of_column("value") == 1
        assert schema.get_meta_data("cat").state_names == ["A", "B", "C"]
        return [schema.get_column_names(),
                [schema.get_type(c) for c in schema.get_column_names()]]
    twin(body)


def test_transform_process_pipeline():
    def body(P):
        tp = (P.datavec.TransformProcess.Builder(_schema3(P))
              .remove_columns("id")
              .double_math_op("value", P.transform.MathOp.Multiply, 2.0)
              .categorical_to_integer("cat")
              .filter(P.transform.ConditionOp.greater_than("value", 100.0))
              .build())
        rows = [[1, 3.0, "B"], [2, 60.0, "A"], [3, 5.0, "C"]]
        out = P.datavec.LocalTransformExecutor.execute_to_values(rows, tp)
        assert out == [[6.0, 1], [10.0, 2]]
        final = tp.get_final_schema()
        assert final.get_column_names() == ["value", "cat"]
        assert final.get_type("cat") == "Integer"
        boxed = P.datavec.LocalTransformExecutor.execute(rows, tp)
        return [out, boxed, final.get_column_names()]
    twin(body)


def test_transform_one_hot_and_rename():
    def body(P):
        schema = (P.datavec.Schema.Builder()
                  .add_column_categorical("color", ["red", "green"])
                  .add_column_double("x")
                  .build())
        tp = (P.datavec.TransformProcess.Builder(schema)
              .rename_column("x", "feature")
              .categorical_to_one_hot("color")
              .build())
        out = P.datavec.LocalTransformExecutor.execute_to_values(
            [["green", 1.5]], tp)
        assert out == [[0, 1, 1.5]]
        names = tp.get_final_schema().get_column_names()
        assert names == ["color[red]", "color[green]", "feature"]
        return [out, names]
    twin(body)


def test_transform_normalize_and_reduce():
    def body(P):
        schema = (P.datavec.Schema.Builder()
                  .add_column_string("key")
                  .add_column_double("v")
                  .build())
        tp = (P.datavec.TransformProcess.Builder(schema)
              .reduce("key", {"v": P.transform.ReduceOp.Mean})
              .build())
        rows = [["a", 1.0], ["a", 3.0], ["b", 10.0]]
        out = P.datavec.LocalTransformExecutor.execute_to_values(rows, tp)
        assert sorted(out) == [["a", 2.0], ["b", 10.0]]
        tp2 = (P.datavec.TransformProcess.Builder(
            P.datavec.Schema.Builder().add_column_double("v").build())
            .normalize("v", "MinMax").build())
        out2 = P.datavec.LocalTransformExecutor.execute_to_values(
            [[0.0], [5.0], [10.0]], tp2)
        assert out2 == [[0.0], [0.5], [1.0]]
        return [sorted(out), out2]
    twin(body)


def test_transform_conditional_replace():
    def body(P):
        schema = P.datavec.Schema.Builder().add_column_integer("v").build()
        tp = (P.datavec.TransformProcess.Builder(schema)
              .conditional_replace_value_transform(
                  "v", 0, P.transform.ConditionOp.less_than("v", 0))
              .build())
        out = P.datavec.LocalTransformExecutor.execute_to_values(
            [[-5], [3]], tp)
        assert out == [[0], [3]]
        return out
    twin(body)


def test_transform_process_record_reader():
    def body(P):
        schema = P.datavec.Schema.Builder().add_column_integer(
            "a", "b").build()
        tp = (P.datavec.TransformProcess.Builder(schema)
              .filter(P.transform.ConditionOp.equals("a", 0))
              .integer_math_op("b", P.transform.MathOp.Add, 10)
              .build())
        rr = P.datavec.CollectionRecordReader([[0, 1], [1, 2], [0, 3],
                                               [2, 4]])
        wrapped = P.records.TransformProcessRecordReader(rr, tp)
        rows = _rows(wrapped)
        assert [[P.writable.unbox(v) for v in r] for r in rows] == \
            [[1, 12], [2, 14]]
        return rows
    twin(body)


def _drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def test_record_reader_dataset_iterator_classification(tmp_path):
    def body(P, tmp_path):
        p = tmp_path / "iris_like.csv"
        lines = ["%f,%f,%d" % (i * 0.1, 1 - i * 0.05, i % 3)
                 for i in range(10)]
        p.write_text("\n".join(lines) + "\n")
        rr = P.datavec.CSVRecordReader().initialize(
            P.datavec.FileSplit(str(p)))
        it = P.record_reader_iterator.RecordReaderDataSetIterator(
            rr, batch_size=4, label_index=2, num_possible_labels=3)
        batches = _drain(it)
        assert np.asarray(batches[0].features).shape == (4, 2)
        assert np.asarray(batches[0].labels).shape == (4, 3)
        assert np.asarray(batches[0].labels).sum() == 4
        assert sum(np.asarray(b.features).shape[0] for b in batches) == 10
        it.reset()
        return batches + [it.next(), it.batch()]
    twin(body, tmp_path)


def test_record_reader_dataset_iterator_regression():
    def body(P):
        rr = P.datavec.CollectionRecordReader([[1.0, 2.0, 3.0],
                                               [4.0, 5.0, 6.0]])
        it = P.record_reader_iterator.RecordReaderDataSetIterator(
            rr, batch_size=2, label_index=2, regression=True)
        ds = it.next()
        assert np.asarray(ds.features).shape == (2, 2)
        assert np.allclose(np.asarray(ds.labels).ravel(), [3.0, 6.0])
        with pytest.raises(ValueError, match="num_possible_labels"):
            P.record_reader_iterator.RecordReaderDataSetIterator(
                rr, batch_size=2, label_index=2)
        multi = P.record_reader_iterator.RecordReaderDataSetIterator(
            P.datavec.CollectionRecordReader([[1.0, 2.0, 3.0, 4.0]]),
            batch_size=1, label_index=1, label_index_to=2)
        return [ds, multi.next()]
    twin(body)


def test_sequence_record_reader_iterator(tmp_path):
    def body(P, tmp_path):
        for i, steps in enumerate([3, 5]):
            lines = ["%f,%f,%d" % (t * 0.1, t * 0.2, t % 2)
                     for t in range(steps)]
            (tmp_path / f"seq_{i}.csv").write_text("\n".join(lines) + "\n")
        rr = P.datavec.CSVSequenceRecordReader().initialize(
            P.datavec.FileSplit(str(tmp_path)))
        it = P.record_reader_iterator.SequenceRecordReaderDataSetIterator(
            rr, batch_size=2, num_possible_labels=2, label_index=2)
        ds = it.next()
        assert np.asarray(ds.features).shape == (2, 5, 2)
        assert np.asarray(ds.features_mask).sum() == 8
        assert np.asarray(ds.labels).shape == (2, 5, 2)
        it.reset()
        regression = P.record_reader_iterator.SequenceRecordReaderDataSetIterator(
            rr, batch_size=1, label_index=0, regression=True)
        return [ds, it.next(), _drain(regression)]
    twin(body, tmp_path)


def test_image_pipeline(tmp_path):
    Image = pytest.importorskip("PIL.Image")

    def body(P, tmp_path):
        for cls in ("cats", "dogs"):
            os.makedirs(tmp_path / cls, exist_ok=True)
            for i in range(2):
                arr = np.random.RandomState(i).randint(
                    0, 255, (20, 24, 3)).astype("uint8")
                Image.fromarray(arr).save(tmp_path / cls / f"{i}.png")
        rr = P.image.ImageRecordReader(
            16, 16, 3, label_generator=P.image.ParentPathLabelGenerator())
        rr.initialize(P.datavec.FileSplit(str(tmp_path),
                                          allowed_extensions=["png"]))
        assert rr.get_labels() == ["cats", "dogs"]
        it = P.record_reader_iterator.RecordReaderDataSetIterator(
            rr, batch_size=4, label_index=1, num_possible_labels=2)
        ds = it.next()
        assert np.asarray(ds.features).shape == (4, 16, 16, 3)
        assert np.asarray(ds.labels).shape == (4, 2)
        img = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
        flipped = P.image.FlipImageTransform(1).transform(img)
        assert np.allclose(flipped[:, 0], img[:, 1])
        resized = P.image.ResizeImageTransform(4, 4).transform(img)
        assert resized.shape == (4, 4, 3)
        pipe = P.image.PipelineImageTransform([P.image.FlipImageTransform(1)],
                                              [1.0], seed=0)
        piped = pipe.transform(img)
        assert piped.shape == img.shape
        return [ds, flipped, resized, piped, rr.get_labels()]
    twin(body, tmp_path)


def test_train_from_csv_end_to_end(tmp_path):
    """The canonical DataVec→DL4J flow: CSV → RecordReaderDataSetIterator →
    MultiLayerNetwork.fit. Both packages' iterators yield the same batches;
    the port's network trains on the port's."""
    rng = np.random.RandomState(0)
    X = rng.rand(80, 3)
    y = (X.sum(axis=1) > 1.5).astype(int)

    def body(P, tmp_path):
        p = tmp_path / "train.csv"
        p.write_text("\n".join(
            ",".join(f"{v:.6f}" for v in row) + f",{label}"
            for row, label in zip(X, y)) + "\n")
        rr = P.datavec.CSVRecordReader().initialize(
            P.datavec.FileSplit(str(p)))
        it = P.record_reader_iterator.RecordReaderDataSetIterator(
            rr, batch_size=16, label_index=3, num_possible_labels=2)
        batches = _drain(it)
        it.reset()
        return batches, it

    for P in (REF, PORT):
        (tmp_path / P.root).mkdir()
    ref_batches, _ = body(REF, tmp_path / REF.root)
    batches, it = body(PORT, tmp_path / PORT.root)
    assert _plain(batches) == _plain(ref_batches)

    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(1).updater(Adam(5e-2))
        .weight_init("xavier").list()
        .layer(DenseLayer(n_in=3, n_out=16, activation="relu"))
        .layer(OutputLayer(n_out=2, activation="softmax",
                           loss_function="mcxent"))
        .set_input_type(InputType.feed_forward(3))
        .build(), device="cpu").init()
    net.fit(it, epochs=30)
    it.reset()
    assert net.evaluate(it).accuracy() > 0.9


def test_resize_transform_preserves_floats():
    def body(P):
        img = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)
        out = P.image.ResizeImageTransform(4, 4).transform(img)
        assert out.shape == (4, 4, 3)
        assert out.max() > 0.2
        const = np.full((6, 6, 1), 0.37, np.float32)
        out2 = P.image.ResizeImageTransform(3, 3).transform(const)
        assert np.allclose(out2, 0.37, atol=1e-6)
        return [out, out2]
    twin(body)


class TestNewReaders:
    def test_regex_line_reader(self, tmp_path):
        def body(P, tmp_path):
            p = os.path.join(str(tmp_path), "log.txt")
            with open(p, "w") as f:
                f.write("2020-01-01 INFO 42 ok\n2020-01-02 WARN 7 slow\n")
            rr = P.datavec.RegexLineRecordReader(
                r"(\d{4}-\d{2}-\d{2}) (\w+) (\d+) (\w+)")
            rr.initialize(P.datavec.FileSplit(p))
            rows = _rows(rr)
            assert len(rows) == 2
            assert rows[0][1].value == "INFO" and rows[0][2].value == 42
            assert rows[1][2].value == 7
            return rows
        twin(body, tmp_path)

    def test_regex_reader_mismatch_raises(self, tmp_path):
        def body(P, tmp_path):
            p = os.path.join(str(tmp_path), "bad.txt")
            with open(p, "w") as f:
                f.write("not-a-match\n")
            rr = P.datavec.RegexLineRecordReader(r"(\d+),(\d+)")
            with pytest.raises(ValueError, match="does not match") as e:
                rr.initialize(P.datavec.FileSplit(p))
            return str(e.value).replace(str(tmp_path), "")
        twin(body, tmp_path)

    def test_jackson_line_reader_with_dotted_paths(self, tmp_path):
        def body(P, tmp_path):
            p = os.path.join(str(tmp_path), "data.jsonl")
            with open(p, "w") as f:
                f.write('{"a": 1, "b": {"c": 2.5}, "d": "x", "e": true}\n')
                f.write('{"a": 2, "b": {"c": 3.5}, "d": "y"}\n')
            rr = P.datavec.JacksonLineRecordReader(["a", "b.c", "d", "e"])
            rr.initialize(P.datavec.FileSplit(p))
            rows = _rows(rr)
            assert rows[0][0].value == 1 and rows[0][1].value == 2.5
            assert rows[0][3].value is True
            assert rows[1][3].value == ""
            return rows
        twin(body, tmp_path)

    def test_resources_cache_and_downloader(self, tmp_path, monkeypatch):
        def body(P, tmp_path):
            R = P.resources
            monkeypatch.setenv("DL4J_TPU_RESOURCE_DIR", str(tmp_path))
            with pytest.raises(R.ResourceError, match="egress"):
                R.Resources.as_file("m/w.bin",
                                    url="https://example.com/w.bin")
            src = tmp_path / "src.bin"
            src.write_bytes(b"weights")
            R.Resources.install(src, "m/w.bin")
            assert R.Resources.exists("m/w.bin")
            got = R.Resources.as_file("m/w.bin").read_bytes()
            assert got == b"weights"
            calls = []

            def fetcher(url, dest):
                calls.append(url)
                dest.write_bytes(b"payload")

            d = R.Downloader(fetcher=fetcher)
            out = d.download("scheme://x", tmp_path / "fetched.bin",
                             md5=hashlib.md5(b"payload").hexdigest())
            assert out.read_bytes() == b"payload"
            assert calls == ["scheme://x"]
            with pytest.raises(R.ResourceError, match="checksum"):
                d.download("scheme://y", tmp_path / "bad.bin", md5="0" * 32)
            return [got, calls, out.name]
        twin(body, tmp_path)


def test_csv_to_matrix_native_fast_path(tmp_path):
    """The port parses with its own ``csv_read_floats`` (the JAX package's
    numpy path); the matrix equals the reference's, bit for bit, and the
    row-of-Writables reader's."""
    def body(P, tmp_path):
        p = os.path.join(str(tmp_path), "nums.csv")
        data = np.random.default_rng(0).normal(size=(50, 6)).astype(
            np.float32)
        np.savetxt(p, data, delimiter=",", fmt="%.6f")
        with open(p, "a") as f:
            f.write("\n1.5,oops,2\n")
        mat = P.records.csv_to_matrix(P.datavec.FileSplit(p))
        assert mat.shape == (51, 6) and mat.dtype == np.float32
        np.testing.assert_allclose(mat[:50], data, atol=1e-5)
        skipped = P.records.csv_to_matrix(P.datavec.FileSplit(p),
                                          skip_num_lines=2)
        rr = P.datavec.CSVRecordReader()
        rr.initialize(P.datavec.FileSplit(p))
        rows = np.asarray([[w.to_double() for w in row]
                           for row in list(rr)[:50]], dtype=np.float32)
        np.testing.assert_allclose(mat[:50], rows, atol=1e-5)
        return [mat[:50], np.isnan(mat[50]), mat[50][~np.isnan(mat[50])],
                skipped.shape]
    twin(body, tmp_path)


def test_transform_tranche2_string_time_math():
    def body(P):
        box, unbox = P.writable.box, P.writable.unbox
        schema = (P.schema.Schema.Builder()
                  .add_column_string("name")
                  .add_column_double("a", "b")
                  .add_column_string("ts")
                  .build())
        tp = (P.transform.TransformProcess.Builder(schema)
              .append_string_column_transform("name", "_x")
              .change_case_transform("name", "upper")
              .string_map_transform("name", {"ALICE_X": "A"})
              .replace_string_transform("name", {"^BOB.*": "B"})
              .double_columns_math_op("sum_ab", "Add", "a", "b")
              .double_columns_math_op("ratio", "Divide", "a", "b")
              .duplicate_column("a", "a2")
              .add_constant_column("k", "Double", 7.0)
              .concat_string_columns("joined", "-", "name", "k")
              .string_to_time_transform("ts", "%Y-%m-%d %H:%M:%S")
              .derive_columns_from_time("ts", "year", "hour", "day_of_week")
              .build())
        rows = [[box("alice"), box(1.5), box(2.5),
                 box("2023-07-04 13:45:00")],
                [box("bob"), box(3.0), box(4.0),
                 box("2024-01-01 00:30:00")]]
        out = tp.execute(rows)
        names = tp.get_final_schema().get_column_names()
        assert names == ["name", "a", "b", "ts", "sum_ab", "ratio", "a2",
                         "k", "joined", "ts_year", "ts_hour",
                         "ts_day_of_week"]
        r0, r1 = out
        assert unbox(r0[0]) == "A" and unbox(r1[0]) == "B"
        assert unbox(r0[names.index("sum_ab")]) == 4.0
        assert unbox(r0[names.index("ts_year")]) == 2023
        assert unbox(r0[names.index("ts_day_of_week")]) == 1
        assert unbox(r1[names.index("ts_year")]) == 2024
        return [out, names,
                [tp.get_final_schema().get_type(n) for n in names]]
    twin(body)


def test_parallel_transform_executor():
    """The Spark-engine analog: partitions over forked workers give the
    local executor's rows, in order."""
    def body(P):
        schema = P.datavec.Schema.Builder().add_column_integer(
            "a", "b").build()
        tp = (P.datavec.TransformProcess.Builder(schema)
              .integer_math_op("b", P.transform.MathOp.Multiply, 3)
              .build())
        rows = [[i, i + 1] for i in range(10)]
        out = P.distributed.ParallelTransformExecutor.execute(
            rows, tp, num_partitions=3)
        assert out == P.datavec.LocalTransformExecutor.execute(rows, tp)
        return out
    twin(body)


# ------------------------------------------ tests/test_interop_arrow.py
def _arrow_schema(P):
    S = P.schema
    return S.Schema([S.ColumnMetaData("id", S.ColumnType.Integer),
                     S.ColumnMetaData("score", S.ColumnType.Double),
                     S.ColumnMetaData("tag", S.ColumnType.String)])


def _arrow_rows(P):
    W = P.writable
    return [[W.IntWritable(1), W.DoubleWritable(0.5), W.Text("a")],
            [W.IntWritable(2), W.DoubleWritable(1.5), W.Text("b")],
            [W.IntWritable(3), W.DoubleWritable(2.5), W.Text("c")]]


class TestArrowBridge:
    def test_round_trip_table(self):
        pytest.importorskip("pyarrow")

        def body(P):
            A = P.datavec.ArrowConverter
            table = A.to_arrow(_arrow_schema(P), _arrow_rows(P))
            assert table.num_rows == 3
            assert table.schema.names == ["id", "score", "tag"]
            back = A.to_datavec(table)
            assert back == _arrow_rows(P)
            sch = A.arrow_schema_to_datavec(table)
            types_ = [sch.get_type(c) for c in ("id", "score", "tag")]
            assert types_ == [P.schema.ColumnType.Integer,
                              P.schema.ColumnType.Double,
                              P.schema.ColumnType.String]
            return [back, types_, table.to_pydict()]
        twin(body)

    @pytest.mark.parametrize("fmt", ["feather", "parquet"])
    def test_file_round_trip(self, tmp_path, fmt):
        pytest.importorskip("pyarrow")

        def body(P, tmp_path):
            path = str(tmp_path / f"data.{'parquet' if fmt == 'parquet' else 'arrow'}")
            A = P.datavec.ArrowConverter
            if fmt == "parquet":
                A.write_parquet(_arrow_schema(P), _arrow_rows(P), path)
            else:
                A.write_ipc(_arrow_schema(P), _arrow_rows(P), path)
            rr = P.datavec.ArrowRecordReader()
            rr.initialize(P.datavec.FileSplit(path))
            got = list(rr)
            assert got == _arrow_rows(P)
            assert rr.schema.get_column_names() == ["id", "score", "tag"]
            return got
        twin(body, tmp_path)

    def test_arrow_reader_feeds_transform_process(self, tmp_path):
        pytest.importorskip("pyarrow")

        def body(P, tmp_path):
            path = str(tmp_path / "t.arrow")
            P.datavec.ArrowConverter.write_ipc(_arrow_schema(P),
                                               _arrow_rows(P), path)
            rr = P.datavec.ArrowRecordReader()
            rr.initialize(P.datavec.FileSplit(path))
            tp = (P.datavec.TransformProcess.Builder(rr.schema)
                  .remove_columns("tag").build())
            out = P.datavec.LocalTransformExecutor.execute(list(rr), tp)
            W = P.writable
            assert out == [[W.IntWritable(1), W.DoubleWritable(0.5)],
                           [W.IntWritable(2), W.DoubleWritable(1.5)],
                           [W.IntWritable(3), W.DoubleWritable(2.5)]]
            return out
        twin(body, tmp_path)


def test_exports_match_the_reference():
    """The port's ``datavec`` exports the reference's names."""
    assert sorted(PORT.datavec.__all__) == sorted(REF.datavec.__all__)
    for name in REF.datavec.__all__:
        assert hasattr(PORT.datavec, name), name
