"""The port's compressed-exchange module (``parallel/compression.py``)
against the JAX package's, on the CPU.

- Algorithms, the spec grammar, the ``DL4J_TPU_GRAD_COMPRESS`` knob and
  its kill switch, bucket layouts, payload and dense bytes, the state
  functions (``init_state``, ``state_matches``, ``reshape_state``):
  exact.
- ``exchange_bucket`` over ``gloo`` at 2 and 4 ranks (processes over a
  ``FileStore``) against the reference's under ``jax.vmap(axis_name=
  "data")`` on the same seeded rows: signs, wire and ``frac`` exact;
  scale, decoded and sent rtol 1e-5 (f32 sums of positives in another
  order); the residual ``acc − sent`` atol 1e-5·scale.
- ``gradCompression.npz`` across the packages, both ways: bit for bit.
  The reference writes it with a hand-set state (its compressed step
  cannot run on this jax); the port's comes from a compressed fit at one
  rank.
"""
import io
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import run_ranks
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu.parallel import compression as JC
from deeplearning4j_tpu.utils import serialization as j_ser
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import updaters as t_upd
from deeplearning4j_tpu_torch.parallel import compression as TC
from deeplearning4j_tpu_torch.utils import serialization as t_ser

RTOL = 1e-5


# ---------------------------------------------------------------- algorithms
SPECS = [None, False, True, "", "0", "1", "fixed", "fixed:0.01",
         "adaptive", "adaptive:0.002", "adaptive:0.002:1e-5:0.05",
         " fixed:1e-4 ", "ADAPTIVE"]
BAD_SPECS = ["fixed:1:2", "adaptive:1:2", "adaptive:a", "topk", "fixed:x"]


def _algo_tuple(a):
    return None if a is None else (type(a).__name__, a.describe())


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_specs_resolve_as_reference(spec):
    assert _algo_tuple(TC.algorithm_from_spec(spec)) == \
        _algo_tuple(JC.algorithm_from_spec(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_as_reference(spec):
    with pytest.raises(ValueError) as t_err:
        TC.algorithm_from_spec(spec)
    with pytest.raises(ValueError) as j_err:
        JC.algorithm_from_spec(spec)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("env,arg", [("", None), ("", "fixed:0.5"),
                                     ("0", "fixed:0.5"), ("0", True),
                                     ("adaptive:0.01", None),
                                     ("adaptive:0.01", "fixed:0.2"),
                                     ("1", None)])
def test_env_knob_and_kill_switch_resolve_as_reference(monkeypatch, env,
                                                        arg):
    monkeypatch.setenv(TC.ENV_KNOB, env)
    assert TC.ENV_KNOB == JC.ENV_KNOB
    assert _algo_tuple(TC.resolve_compression(arg)) == \
        _algo_tuple(JC.resolve_compression(arg))


@pytest.mark.parametrize("frac", [0.0, 5e-5, 1e-4, 5e-3, 1e-2, 0.3, 1.0])
@pytest.mark.parametrize("t", [1e-3, 1e-10, 1e6, 3.7e-2])
def test_threshold_updates_are_the_references_bits(frac, t):
    for kind in ("Fixed", "Adaptive"):
        j = getattr(JC, f"{kind}ThresholdAlgorithm")()
        p = getattr(TC, f"{kind}ThresholdAlgorithm")()
        want = np.float32(j.update(jnp.float32(t), jnp.float32(frac)))
        got = p.update(torch.tensor(t, dtype=torch.float32),
                       torch.tensor(frac, dtype=torch.float32))
        assert got.dtype == torch.float32
        assert np.float32(got.item()).tobytes() == want.tobytes()


# ------------------------------------------------------------------- buckets
def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"0": {"W": (3, 4), "b": (4,)}, "1": {"W": (4, 2), "b": (2,)},
              "2": {"gamma": (5,)}}
    return {k: {p: rng.standard_normal(s).astype(np.float32)
                for p, s in layer.items()} for k, layer in shapes.items()}


def test_buckets_round_trip_as_reference():
    tree = _trees()
    jl = JC.build_layout(jax.tree.map(jnp.asarray, tree))
    leaves = [torch.as_tensor(tree[k][p]) for k in sorted(tree)
              for p in sorted(tree[k])]
    tl = TC.build_layout(leaves)
    assert tl.bucket_sizes == jl.bucket_sizes
    assert tl.bucket_dtypes == jl.bucket_dtypes
    assert [(s.bucket, s.offset, s.size, s.shape, s.dtype)
            for s in tl.slots] == [(s.bucket, s.offset, s.size, s.shape,
                                    s.dtype) for s in jl.slots]
    jb = JC.flatten_buckets(jax.tree.map(jnp.asarray, tree), jl)
    tb = TC.flatten_buckets(leaves, tl)
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
    back = TC.unflatten_buckets(tb, tl)
    for a, b in zip(back, leaves):
        assert torch.equal(a, b)
    for n in (1, 2, 127, 128, 300):
        assert TC.payload_bytes(tl, n) == JC.payload_bytes(jl, n)
    assert TC.dense_bytes(tl) == JC.dense_bytes(jl)
    with pytest.raises(ValueError, match="non-float"):
        TC.build_layout([torch.zeros(3, dtype=torch.int32)])


def test_mixed_dtype_leaves_form_one_bucket_each():
    leaves = [torch.zeros(3), torch.zeros(2, dtype=torch.float64),
              torch.ones(4)]
    lay = TC.build_layout(leaves)
    assert lay.bucket_dtypes == ("float32", "float64")
    assert lay.bucket_sizes == (7, 2)
    back = TC.unflatten_buckets(TC.flatten_buckets(leaves, lay), lay)
    assert [t.dtype for t in back] == [torch.float32, torch.float64,
                                       torch.float32]


def _state_pair(n, sizes, seed=0):
    rng = np.random.default_rng(seed)
    res = [rng.standard_normal((n, s)).astype(np.float32) for s in sizes]
    thr = [np.float32(1e-3 * (i + 1)) for i in range(len(sizes))]
    return ({"residual": [jnp.asarray(r) for r in res],
             "threshold": [jnp.asarray(t) for t in thr]},
            {"residual": [torch.as_tensor(r) for r in res],
             "threshold": [torch.as_tensor(t) for t in thr]})


@pytest.mark.parametrize("old_n,new_n", [(2, 2), (4, 2), (2, 4), (3, 2),
                                         (4, 1), (1, 3)])
def test_state_reshapes_as_reference(old_n, new_n):
    tree = _trees()
    jl = JC.build_layout(jax.tree.map(jnp.asarray, tree))
    tl = TC.build_layout([torch.as_tensor(tree[k][p]) for k in sorted(tree)
                          for p in sorted(tree[k])])
    js, ts = _state_pair(old_n, jl.bucket_sizes)
    assert TC.state_matches(ts, tl, new_n) == JC.state_matches(js, jl, new_n)
    jr, jmode = JC.reshape_state(js, jl, new_n)
    tr, tmode = TC.reshape_state(ts, tl, new_n)
    assert tmode == jmode
    for a, b in zip(tr["residual"], jr["residual"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
    for a, b in zip(tr["threshold"], jr["threshold"]):
        assert a.numpy().tobytes() == np.asarray(b, np.float32).tobytes()
    # a layout change salvages nothing
    other = TC.build_layout([torch.zeros(5)])
    assert TC.reshape_state(ts, other, new_n) == (None, "layout_mismatch")
    fresh = TC.init_state(tl, TC.FixedThresholdAlgorithm(0.5), new_n)
    jfresh = JC.init_state(jl, JC.FixedThresholdAlgorithm(0.5), new_n)
    assert [tuple(r.shape) for r in fresh["residual"]] == \
        [tuple(r.shape) for r in jfresh["residual"]]
    assert float(fresh["threshold"][0]) == float(jfresh["threshold"][0])


# ----------------------------------------------------- the exchange over gloo
EX_SIZE = 4099
EX_T = 8e-4


def _rows(world, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((world, EX_SIZE)).astype(np.float32) * 1e-3
    res = rng.standard_normal((world, EX_SIZE)).astype(np.float32) * 1e-4
    g[world - 1, :] *= 1e-3       # one replica fires nothing
    return g, res


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_over_gloo_matches_reference_vmap(world, tmp_path):
    g, res = _rows(world, seed=world)
    out = run_ranks(world, {"ex": {"kind": "exchange", "g": g, "res": res,
                                   "t": EX_T}}, tmp_path)
    acc = jnp.asarray(g + res)
    dec, sent, fired, frac = jax.vmap(
        lambda a: JC.exchange_bucket(a, jnp.float32(EX_T), "data", world),
        axis_name="data")(acc)
    wire = np.asarray(JC.encode_dense(acc, EX_T), np.int64).sum(0)
    assert not np.asarray(fired[world - 1]).any()
    for r in range(world):
        e = out[r]["ex"]
        np.testing.assert_array_equal(e["signs"] != 0,
                                      np.asarray(fired[r]) > 0)
        np.testing.assert_array_equal(
            e["signs"], np.asarray(JC.encode_dense(acc[r], EX_T)))
        np.testing.assert_array_equal(e["wire"].astype(np.int64), wire)
        assert e["wire"].dtype == np.int8
        assert e["frac"] == np.float32(frac[r])
        np.testing.assert_allclose(e["decoded"], np.asarray(dec[r]),
                                   rtol=RTOL)
        np.testing.assert_allclose(e["sent"], np.asarray(sent[r]), rtol=RTOL)
        np.testing.assert_allclose(e["residual"],
                                   np.asarray(acc[r] - sent[r]), rtol=0,
                                   atol=RTOL * float(e["scale"]))
    # the scale is the same on every rank: averaged over the ranks that
    # fired anything
    assert len({float(out[r]["ex"]["scale"]) for r in range(world)}) == 1


# ------------------------------------------------------- gradCompression.npz
def _lenet(ns, cfg):
    L = ns[2]
    return (ns[0].NeuralNetConfiguration.builder().seed(3)
            .updater(ns[3].Sgd(0.1)).list()
            .layer(L.DenseLayer(n_out=6, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns[1].InputType.feed_forward(5)).build())


J_NS = (j_cfg, j_inputs, j_layers, j_upd)
T_NS = (t_cfg, t_inputs, t_layers, t_upd)


def _npz(path):
    with zipfile.ZipFile(path) as zf:
        with np.load(io.BytesIO(zf.read("gradCompression.npz"))) as z:
            return {k: z[k] for k in z.files}


def test_grad_compression_npz_from_the_reference_restores_bitwise(tmp_path):
    ref = j_mln.MultiLayerNetwork(_lenet(J_NS, None)).init()
    layout = JC.build_layout(ref._params)
    state = JC.init_state(layout, JC.AdaptiveThresholdAlgorithm(), 2)
    rng = np.random.default_rng(1)
    state["residual"] = [jnp.asarray(rng.standard_normal(
        np.shape(r)).astype(np.float32)) for r in state["residual"]]
    state["threshold"] = [jnp.float32(7.5e-4)]
    ref._grad_compression_state = state
    path = str(tmp_path / "ref.zip")
    ref.save(path)
    net = t_ser.ModelSerializer.restore(path, device="cpu")
    got = net._grad_compression_state
    want = _npz(path)
    assert got["residual"][0].numpy().tobytes() == \
        want["residual_0"].tobytes()
    assert got["threshold"][0].numpy().tobytes() == \
        want["threshold_0"].tobytes()
    # and through the port's own save, the same bytes again
    again = str(tmp_path / "port.zip")
    net.save(again)
    for k, v in want.items():
        assert _npz(again)[k].tobytes() == v.tobytes(), k


def test_grad_compression_npz_from_the_port_restores_bitwise(tmp_path):
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec
    from deeplearning4j_tpu_torch.parallel.trainer import ShardedTrainer
    net = t_mln.MultiLayerNetwork(_lenet(T_NS, None), device="cpu").init()
    tr = ShardedTrainer(net, MeshSpec.data_parallel(),
                        grad_compression="adaptive:0.01")
    rng = np.random.default_rng(2)
    for _ in range(3):
        x = rng.standard_normal((6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
        tr.fit(x, y)
    state = net._grad_compression_state
    assert state["world"] == 1 and tuple(state["residual"][0].shape) == (
        1, net.numParams())
    assert np.any(state["residual"][0].numpy())
    path = str(tmp_path / "port.zip")
    net.save(path)
    ref = j_ser.ModelSerializer.restore(path)
    arrays = _npz(path)
    assert np.asarray(ref._grad_compression_state["residual"][0]).tobytes() \
        == state["residual"][0].numpy().tobytes() \
        == arrays["residual_0"].tobytes()
    assert np.asarray(ref._grad_compression_state["threshold"][0],
                      np.float32).tobytes() == \
        state["threshold"][0].numpy().tobytes()
    # restored into the port and placed again: rank 0's row, and the
    # reference's reshape when the replica count differs
    back = t_ser.ModelSerializer.restore(path, device="cpu")
    ShardedTrainer(back, MeshSpec.data_parallel(),
                   grad_compression="adaptive:0.01")._place()
    assert torch.equal(back._grad_compression_state["residual"][0],
                       state["residual"][0])
    two = t_ser.ModelSerializer.restore(path, device="cpu")
    two._grad_compression_state["residual"] = [torch.cat(
        [r, 3 * r]) for r in two._grad_compression_state["residual"]]
    ShardedTrainer(two, MeshSpec.data_parallel(),
                   grad_compression="adaptive:0.01")._place()
    np.testing.assert_allclose(two._grad_compression_state["residual"][0],
                               2 * state["residual"][0], rtol=1e-6)
