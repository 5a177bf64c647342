"""The port's TrainingMaster facades, ``ParallelWrapper``, the mesh, the
process-group bootstrap and the data-parallel seams, against the JAX
package's where it has them, on the CPU at one rank (a one-rank ``gloo``
group in this process; the several-rank paths are in
``tests/test_torch_sharded_trainer.py`` and
``tests/test_torch_compression.py``).

- The masters and Builders (``threshold`` → ``fixed:t``),
  ``ParameterAveragingTrainingMaster``, ``_rebatch``, ``MeshSpec``'s
  resolution and errors: as the reference's, exactly.
- ``SparkComputationGraph`` / ``SparkDl4jMultiLayer`` and
  ``ParallelWrapper`` at one rank: the net's own ``fit`` on the
  re-batched stream, bit for bit.
- Refusals: TBPTT falls back to the dense exchange (as the reference);
  tensor parallelism, ZeRO, ring attention, a model axis and several
  nodes raise naming ROADMAP queue 1 item 7B; asking for the card
  without CUDA raises.
- The observability names (``dl4j_collective_*``,
  ``dl4j_grad_compression_*``, ``dl4j_grad_residual_norm``,
  ``dl4j_mesh_devices``) and their help and labels equal the
  reference's; the ``allreduce`` fault point fires under both
  exchanges.
"""
import ast
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.observability import global_registry as j_registry
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu.parallel import master as JM
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel.trainer import ShardedTrainer as JTrainer
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.observability import (
    global_registry as t_registry)
from deeplearning4j_tpu_torch.optim import updaters as t_upd
from deeplearning4j_tpu_torch.parallel import master as TM
from deeplearning4j_tpu_torch.parallel import mesh as t_mesh
from deeplearning4j_tpu_torch.parallel import sharding as t_sharding
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec
from deeplearning4j_tpu_torch.parallel.trainer import (ParallelWrapper,
                                                       ShardedTrainer)
from deeplearning4j_tpu_torch.resilience import faults as t_faults

ROOT = Path(__file__).resolve().parent.parent
J_NS = (j_cfg, j_inputs, j_layers, j_upd)
T_NS = (t_cfg, t_inputs, t_layers, t_upd)


def mlp_conf(ns, tbptt=False):
    cfg, inputs, L, U = ns
    b = cfg.NeuralNetConfiguration.builder().seed(3).updater(U.Sgd(0.1))
    if tbptt:
        return (b.list()
                .layer(L.LSTM(n_out=4, activation="tanh"))
                .layer(L.RnnOutputLayer(n_out=3, activation="softmax",
                                        loss_function="mcxent"))
                .set_input_type(inputs.InputType.recurrent(2))
                .backprop_type(cfg.BackpropType.TruncatedBPTT)
                .t_bptt_length(3).build())
    return (b.list()
            .layer(L.DenseLayer(n_out=6, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(inputs.InputType.feed_forward(5)).build())


def port_net(tbptt=False):
    return t_mln.MultiLayerNetwork(mlp_conf(T_NS, tbptt), device="cpu").init()


def stream(sizes, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
             if labels else None) for n in sizes]


def _master_state(m):
    return {k: getattr(m, k) for k in ("batch_size_per_worker", "workers",
                                       "tensor_parallel", "threshold",
                                       "threshold_algorithm",
                                       "averaging_frequency")
            if hasattr(m, k)}


@pytest.mark.parametrize("build", [
    lambda M: M.SharedTrainingMaster.Builder().batch_size_per_worker(16)
    .threshold(0.02).build(),
    lambda M: M.SharedTrainingMaster.Builder().batchSizePerWorker(8)
    .thresholdAlgorithm("adaptive").workersPerNode(1).build(),
    lambda M: M.SharedTrainingMaster.Builder().threshold(0.1)
    .threshold_algorithm("fixed:0.3").build(),
    lambda M: M.SharedTrainingMaster(threshold=5e-4),
    lambda M: M.SharedTrainingMaster(workers_per_node=1),
    lambda M: M.ParameterAveragingTrainingMaster.Builder()
    .batch_size_per_worker(4).averagingFrequency(5).build(),
    lambda M: M.TrainingMaster(tensor_parallel=3),
])
def test_masters_and_builders_as_reference(build):
    t, j = build(TM), build(JM)
    assert _master_state(t) == _master_state(j)
    assert t.mesh_spec().axes == j.mesh_spec().axes


@pytest.mark.parametrize("sizes,target", [((3, 5, 7), 4), ((8,), 8),
                                          ((2, 2, 2), 5), ((10,), 3)])
def test_rebatch_as_reference(sizes, target):
    data = stream(sizes)
    got = list(TM._rebatch([TDataSet(x, y) for x, y in data], target))
    want = list(JM._rebatch([JDataSet(x, y) for x, y in data], target))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.features),
                                      np.asarray(b.features))
        np.testing.assert_array_equal(np.asarray(a.labels),
                                      np.asarray(b.labels))
    masked = TDataSet(data[0][0], data[0][1],
                      features_mask=np.ones((sizes[0], 1), np.float32))
    assert list(TM._rebatch([masked], target))[0] is masked
    x, y = data[0]
    with pytest.raises(ValueError, match="mixed labeled"):
        list(TM._rebatch([TDataSet(x, y), TDataSet(x, None)], 100))


@pytest.mark.parametrize("axes,n", [({"data": -1}, 8), ({"data": 2}, 8),
                                    ({"data": -1, "model": 2}, 8),
                                    ({"data": -1, "model": 3}, 8),
                                    ({"data": -1, "model": -1}, 4),
                                    ({"data": 2, "model": 2, "seq": 2}, 8)])
def test_mesh_resolution_as_reference(axes, n):
    def run(spec_cls):
        try:
            return spec_cls(dict(axes)).resolve(n)
        except ValueError as e:
            return str(e)
    assert run(MeshSpec) == run(JMeshSpec)


def test_one_rank_mesh_and_its_refusals():
    mesh = MeshSpec.data_parallel().build(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.axis_names) == (1, 0, ("data",))
    assert t_mesh.axis_size(mesh, "data") == 1
    assert t_mesh.axis_size(mesh, "model") == 1
    assert t_mesh.backend_for(mesh.device) == "gloo"
    with pytest.raises(ValueError, match="devices"):
        MeshSpec.data_parallel(2).build(device="cpu")
    with pytest.raises(ValueError, match="one rank a device"):
        MeshSpec.data_parallel().build(devices=[0, 1], device="cpu")
    # a model axis past 1 is tensor parallelism: ROADMAP queue 1 item 7B
    tp = t_mesh.Mesh(("data", "model"), {"data": 1, "model": 2}, 2, 0,
                     torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 7B"):
        t_sharding.tp_shardings({"0": {"W": torch.zeros(2, 2)}}, tp)
    assert t_sharding.tp_shardings({"0": {"W": torch.zeros(2, 2)}}, tp,
                                   enable=False) == {"0": {"W": ()}}
    for pname, ndim in (("W", 2), ("W", 4), ("b", 1), ("gamma", 1),
                        ("RW", 2), ("x", 3)):
        from deeplearning4j_tpu.parallel.sharding import param_pspec
        assert t_sharding.param_pspec(pname, ndim) == tuple(
            param_pspec(pname, ndim))


def test_seven_b_paths_raise():
    net = port_net()
    with pytest.raises(NotImplementedError, match="item 7B"):
        ShardedTrainer(net, tensor_parallel=True)
    with pytest.raises(NotImplementedError, match="item 7B"):
        TM.TrainingMaster(tensor_parallel=True).make_trainer(net)
    with pytest.raises(NotImplementedError, match="item 7B"):
        ShardedTrainer(net, shard_optimizer_state=True)
    import deeplearning4j_tpu_torch.parallel as P
    assert not hasattr(P, "ring_attention")


def test_several_nodes_raise(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="several nodes.*item 7B"):
        ShardedTrainer(port_net())


def test_the_card_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshSpec.data_parallel().build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.DistributedConfig(num_processes=1, process_id=0).initialize()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_mln.MultiLayerNetwork(mlp_conf(T_NS))
    assert t_mesh.backend_for(torch.device("cuda")) == "nccl"
    assert t_mesh.backend_for(torch.device("cpu")) == "gloo"


def test_tbptt_keeps_the_dense_exchange_as_reference(caplog):
    net = port_net(tbptt=True)
    with caplog.at_level(logging.WARNING):
        tr = ShardedTrainer(net, grad_compression="fixed:0.01")
        tr._place()
    assert tr._compression is None
    assert any("TBPTT" in r.getMessage() for r in caplog.records)
    ref = j_mln.MultiLayerNetwork(mlp_conf(J_NS, tbptt=True)).init()
    jt = JTrainer(ref, JMeshSpec.data_parallel(1), devices=jax.devices()[:1],
                  grad_compression="fixed:0.01")
    jt._place()
    assert jt._compression is None


def _fit_plain(data, target):
    net = port_net()
    for ds in TM._rebatch([TDataSet(x, y) for x, y in data], target):
        net.fit(ds.features, ds.labels)
    return net


@pytest.mark.parametrize("kill_switch", [False, True])
def test_spark_facades_at_one_rank_are_the_nets_own_fit(kill_switch,
                                                       monkeypatch):
    builder = TM.SharedTrainingMaster.Builder().batch_size_per_worker(4)
    if kill_switch:
        # SharedTrainingMaster's algorithm asks for compression, the
        # knob's 0 keeps the dense exchange
        monkeypatch.setenv("DL4J_TPU_GRAD_COMPRESS", "0")
        builder = builder.threshold_algorithm("adaptive")
    data = stream((3, 5, 4, 6))
    want = _fit_plain(data, 4)
    net = port_net()
    tm = builder.build()
    spark = TM.SparkDl4jMultiLayer(None, net, tm)
    assert spark.getNetwork() is net
    spark.fit([TDataSet(x, y) for x, y in data])
    for k in want.param_tree():
        for p in want.param_tree()[k]:
            assert torch.equal(net.param_tree()[k][p],
                               want.param_tree()[k][p]), (k, p)
    assert net._grad_compression_state is None


def test_parallel_wrapper_at_one_rank_is_the_nets_own_fit():
    data = stream((6, 6))
    want = port_net()
    for x, y in data:
        want.fit(x, y)
    net = port_net()
    pw = (ParallelWrapper.builder(net).workers(1).prefetchBuffer(2)
          .averagingFrequency(3).build())
    for x, y in data:
        pw.fit(x, y)
    pw.shutdown()
    for k in want.param_tree():
        for p in want.param_tree()[k]:
            assert torch.equal(net.param_tree()[k][p],
                               want.param_tree()[k][p])
    with pytest.raises(ValueError):
        ParallelWrapper(port_net(), workers=2)


def _families(text, prefixes):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(("# HELP ", "# TYPE "))
                  and ln.split()[2].startswith(prefixes))


def test_observability_names_as_reference():
    net = port_net()
    ShardedTrainer(net, grad_compression="fixed:0.01")._place()
    ref = j_mln.MultiLayerNetwork(mlp_conf(J_NS)).init()
    JTrainer(ref, JMeshSpec.data_parallel(2), devices=jax.devices()[:2],
             grad_compression="fixed:0.01")._place()
    prefixes = ("dl4j_collective_", "dl4j_grad_compression_",
                "dl4j_grad_residual_norm", "dl4j_mesh_devices")
    got = _families(t_registry().render_prometheus(), prefixes)
    want = _families(j_registry().render_prometheus(), prefixes)
    assert got and got == want
    for name in ("dl4j_collective_bytes_total",
                 "dl4j_collective_expected_bytes",
                 "dl4j_collective_step_seconds", "dl4j_mesh_devices",
                 "dl4j_grad_compression_ratio",
                 "dl4j_grad_compression_sparsity_ratio",
                 "dl4j_grad_residual_norm"):
        assert t_registry().get(name) is not None, name


@pytest.mark.parametrize("compression", [None, "fixed:0.01"])
def test_allreduce_fault_point_fires_under_both_exchanges(compression):
    net = port_net()
    tr = ShardedTrainer(net, grad_compression=compression)
    x, y = stream((4,))[0]
    plan = t_faults.FaultPlan([t_faults.FaultSpec("allreduce", "error",
                                                  rate=1.0, count=1)])
    t_faults.reset()
    try:
        with t_faults.active(plan):
            with pytest.raises(t_faults.InjectedFault, match="allreduce"):
                tr.fit(x, y)
            assert net._iteration == 0
            tr.fit(x, y)                  # count 1: the retry runs
        assert net._iteration == 1
        assert (tr._compression is None) == (compression is None)
    finally:
        t_faults.reset()


def test_multiprocess_probe_runs_two_gloo_ranks(monkeypatch):
    monkeypatch.setattr(TM, "_MULTIPROC_PROBE", None)
    monkeypatch.delenv("DL4J_TPU_MULTIHOST_PROBE", raising=False)
    ok, why = TM.multiprocess_cpu_collectives_supported()
    assert ok, why
    monkeypatch.setenv("DL4J_TPU_MULTIHOST_PROBE", "0")
    assert TM.multiprocess_cpu_collectives_supported()[0] is False


def _public(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


#: module → (reference-only names, port-only names), each with a reason
SURFACES = {
    "parallel/master": ({}, {}),
    "parallel/trainer": ({}, {
        "DROPOUT_STRIDE": "the seed offset of rank r's dropout draws (the "
                          "reference shards one global mask instead)"}),
    "parallel/sharding": ({}, {}),
    "parallel/compression": ({}, {
        "Exchanged": "one bucket's exchange as the port returns it",
        "exchange_buckets": "several buckets with one scalar all-reduce",
        "all_reduce": "the counted process-group all-reduce",
        "mean_over": "the dense exchange's mean over the ranks",
        "allreduce_calls": "its counter"}),
    "parallel/mesh": ({
        "replicated": "a jax NamedSharding; the port's data-parallel "
                      "ranks hold whole tensors",
        "batch_sharding": "the same: a rank takes its rows itself"}, {
        "Mesh": "the port's mesh object (jax.sharding.Mesh there)",
        "ITEM_7B": "the raises' ROADMAP item",
        "backend_for": "nccl on the card, gloo on the CPU",
        "ensure_group": "starts the process group",
        "world_from_env": "WORLD_SIZE"}),
    "kernels/threshold": ({}, {
        n: "K6's dense kernels, their plain versions and counters (the "
           "reference's lax in parallel/compression.py)"
        for n in ("encode_dense", "decode_dense", "encode_dense_reference",
                  "decode_dense_reference", "threshold_encode_reference",
                  "threshold_decode_reference",
                  "sparse_from_dense_reference",
                  "dense_from_sparse_reference", "launches_encode", "launches_decode",
                  "launches_sparse_encode", "launches_sparse_decode")}),
}


@pytest.mark.parametrize("module", sorted(SURFACES))
def test_public_names_equal_the_reference(module):
    ref_only, port_only = SURFACES[module]
    ref = _public(ROOT / "deeplearning4j_tpu" / f"{module}.py")
    port = _public(ROOT / "deeplearning4j_tpu_torch" / f"{module}.py")
    assert ref - port == set(ref_only), module
    assert port - ref == set(port_only), module
