"""Run the port's data-parallel jobs on several CPU ranks: ``gloo`` over a
``FileStore`` under the test's ``tmp_path`` (never a fixed TCP port: the
suite runs files in parallel).

:func:`run_ranks` spawns ``world`` processes of this file once for a whole
group of jobs; each rank runs every job in order and writes its results
with ``torch.save``. The workers import torch, numpy and the port, never
JAX or the JAX package::

    python tests/_torch_dist.py JOBS RANK WORLD STORE OUT
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def run_ranks(world: int, jobs: dict, tmp_path, timeout: float = 300.0):
    """Each rank's results ({job name: result}), in rank order."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    job_file = tmp / f"jobs_{world}.pt"
    torch.save(jobs, job_file)
    store = tmp / f"store_{world}"
    outs = [tmp / f"out_{world}_{r}.pt" for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(job_file), str(r), str(world),
         str(store), str(outs[r])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"ranks failed {bad}:\n" + "\n".join(
            f"--- rank {r}\n{logs[r][-4000:]}" for r, _ in bad))
    return [torch.load(o, weights_only=False) for o in outs]


# ------------------------------------------------------------- the jobs
def _np(t):
    return t.detach().cpu().numpy().copy()


def _tree_np(tree):
    return {k: {p: _np(v) for p, v in layer.items()}
            for k, layer in tree.items()}


def build_net(spec):
    """A port net on the CPU from a spec: ``kind`` ("mln" or "cg"),
    ``conf`` (the configuration's JSON), ``params`` and ``states``
    (numpy trees)."""
    from deeplearning4j_tpu_torch.nn import graph as t_graph
    from deeplearning4j_tpu_torch.nn import multilayer as t_mln
    from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
    from deeplearning4j_tpu_torch.nn import graph_conf as t_gc
    if spec["kind"] == "mln":
        net = t_mln.MultiLayerNetwork(
            t_cfg.MultiLayerConfiguration.from_json(spec["conf"]),
            device="cpu")
    else:
        net = t_graph.ComputationGraph(
            t_gc.ComputationGraphConfiguration.from_json(spec["conf"]),
            device="cpu")
    net.init()
    net.set_param_tree(spec["params"])
    net.set_state_tree(spec["states"])
    return net


def job_exchange(job, rank, world, group):
    """One bucket's exchange: rank r's g and residual are row r."""
    from deeplearning4j_tpu_torch.parallel import compression as comp
    g = torch.as_tensor(job["g"][rank]).clone()
    res = torch.as_tensor(job["res"][rank]).clone()
    t = torch.tensor(job["t"], dtype=torch.float32)
    e = comp.exchange_bucket(g, res, t, group, world)
    return {k: _np(getattr(e, k)) for k in ("decoded", "residual", "signs",
                                             "wire", "scale", "frac",
                                             "res_sq")} | {
        "sent": _np(e.sent)}


def job_fit(job, rank, world, group):
    """``ShardedTrainer`` over the world on ``job["batches"]`` (global
    batches, one ``fit(x, y)`` each, or with ``job["iterator"]`` one epoch
    of an iterator of that batch size over them): the scores, and after
    the last step the params, states, updater leaves and compression
    state; with compression, each step's exchange inputs and signs."""
    from deeplearning4j_tpu_torch.optim import transforms as T
    from deeplearning4j_tpu_torch.parallel import compression as comp
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec
    from deeplearning4j_tpu_torch.parallel.trainer import ShardedTrainer
    net = build_net(job["net"])
    tr = ShardedTrainer(net, MeshSpec.data_parallel(),
                        grad_compression=job.get("compression"))
    steps = []
    real = comp.exchange_buckets

    def spy(gs, residuals, thresholds, *a, **kw):
        rec = {"g": [_np(g) for g in gs],
               "residual": [_np(r) for r in residuals],
               "threshold": [float(t) for t in thresholds]}
        out = real(gs, residuals, thresholds, *a, **kw)
        rec["signs"] = [_np(e.signs) for e in out]
        steps.append(rec)
        return out

    comp.exchange_buckets = spy
    scores = []
    try:
        if job.get("iterator"):
            # one epoch over the batches as an iterator: the prefetch
            # thread's placement takes this rank's rows
            from deeplearning4j_tpu_torch.data.iterators import (
                ArrayDataSetIterator)
            xs, ys = zip(*job["batches"])
            tr.fit(ArrayDataSetIterator(np.concatenate(xs),
                                        np.concatenate(ys),
                                        job["iterator"]))
            scores.append(tr.score())
        else:
            for x, y in job["batches"]:
                tr.fit(x, y)
                scores.append(tr.score())
    finally:
        comp.exchange_buckets = real
    state = net._grad_compression_state
    out = {"scores": scores, "params": _tree_np(net.param_tree()),
           "states": _tree_np(net.state_tree()),
           "updater": [_np(t) if isinstance(t, torch.Tensor) else t
                       for t in T.state_leaves(net.updater_state())],
           "steps": steps, "compression": None}
    if state is not None:
        out["compression"] = {
            "residual": [_np(r) for r in state["residual"]],
            "threshold": [float(t) for t in state["threshold"]]}
    return out


def sd_graph(pkg, w1, w2, lr):
    """The SameDiff MLP both packages build: tanh(x·w1)·w2 under an MSE
    loss, Adam(lr). ``pkg`` holds ``sd`` (a SameDiff factory),
    ``TrainingConfig`` and ``Adam``."""
    sd = pkg["sd"]()
    x = sd.placeholder("x", (None, w1.shape[0]), np.float32)
    y = sd.placeholder("y", (None, w2.shape[1]), np.float32)
    a = sd.var("w1", init=w1)
    b = sd.var("w2", init=w2)
    pred = sd.nn.tanh(x.mmul(a)).mmul(b)
    sd.loss.mse(y, pred).rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(pkg["TrainingConfig"](
        updater=pkg["Adam"](lr), data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"]))
    return sd


def job_samediff(job, rank, world, group):
    from deeplearning4j_tpu_torch.autodiff import samediff as T
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.optim import updaters as U
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec
    sd = sd_graph({"sd": lambda: T.SameDiff.create("cpu"),
                   "TrainingConfig": T.TrainingConfig, "Adam": U.Adam},
                  job["w1"], job["w2"], job["lr"])
    sd.set_mesh(MeshSpec.data_parallel().build(device="cpu"))
    losses = list(sd.fit([DataSet(x, y) for x, y in job["batches"]]))
    return {"losses": losses,
            "values": {n: _np(sd._values[n]) for n in ("w1", "w2")}}


JOBS = {"exchange": job_exchange, "fit": job_fit, "samediff": job_samediff}


def main(argv):
    job_file, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.master import DistributedConfig
    DistributedConfig(num_processes=world, process_id=rank, device="cpu",
                      store=dist.FileStore(store, world)).initialize()
    jobs = torch.load(job_file, weights_only=False)
    results = {}
    for name, job in jobs.items():
        results[name] = JOBS[job["kind"]](job, rank, world,
                                          dist.group.WORLD)
    torch.save(results, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(sys.argv[1:])
