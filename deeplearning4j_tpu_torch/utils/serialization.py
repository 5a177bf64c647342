"""Model persistence: counterpart of ``deeplearning4j_tpu/utils/serialization.py``,
analog of ``org.deeplearning4j.util.ModelSerializer`` (SURVEY D9/§5.4).

One portable zip, in the JAX package's layout, so a zip written by either
package restores in the other:

- ``configuration.json`` — the config DSL's JSON;
- ``coefficients.npz``   — params keyed ``"{layer}/{param}"``;
- ``state.npz``          — layer states (BatchNormalization's running
  mean and var), keyed the same way;
- ``updaterState.npz``   — the optimizer state's leaves as ``leaf_i``, in
  ``jax.tree.leaves`` order of the matching optax state
  (``optim/transforms.py``'s :func:`state_leaves`); a step count is an
  int32 scalar, as optax keeps it;
- ``normalizer.json`` / ``normalizer.npz`` — an optional fitted
  ``DataNormalization``;
- ``meta.json``          — ``iteration``, ``epoch``, ``format_version`` 1,
  ``model_type``;
- ``gradCompression.npz`` — the compressed-gradient exchange's state
  (``parallel/compression.py``): ``residual_<i>`` (n_replicas, size) and
  ``threshold_<i>`` for each bucket, as the reference writes it; over
  several ranks every rank calls ``save`` (the rows are gathered) and rank
  0 writes the zip.

Every float array is f32: master params, states and updater state are f32
in both packages, and ``np.savez`` of a bfloat16 array could not be read
back without ml_dtypes. A non-f32 leaf is refused loudly, on write and on
read.

``save`` copies each tensor to the host once and leaves the net's own
tensors where they are; a restore builds the whole tree on the host and
moves it to the net's device in one pass. The ``.npz`` members are stored
in the zip uncompressed: deflate shrinks f32 weights by ~7 % at ~20 MB/s
of one core, seconds for ResNet-50's ~100 MB, and a stored member reads
back in either package alike; the JSON members are deflated. Restores go
to the card unless the caller passes ``device="cpu"``. A zip holding
``coefficients.bin`` is a DL4J artifact and goes to
``modelimport/dl4j_zip.py``.
"""
from __future__ import annotations

import io
import json
import logging
import os
import re
import zipfile
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optim import transforms as T

log = logging.getLogger("deeplearning4j_tpu_torch")

def _save_npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _f32_host(t, what: str) -> np.ndarray:
    """``t`` (a tensor or array) as an f32 numpy array on the host: one copy
    from the card, the net's own tensor untouched. Refuses any other
    floating type."""
    if isinstance(t, torch.Tensor):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} is {t.dtype}; zips hold f32 only")
        return t.detach().cpu().numpy()
    a = np.asarray(t)
    if a.dtype != np.float32:
        raise TypeError(f"{what} is {a.dtype}; zips hold f32 only")
    return a


def _read_f32(z, key: str, what: str) -> np.ndarray:
    a = z[key]
    if a.dtype != np.float32:
        raise TypeError(f"{what} {key!r} in the zip is {a.dtype}; the port "
                        f"reads f32 only (a bfloat16 array needs ml_dtypes)")
    return a


def _tree_to_npz(tree, what: str) -> dict:
    return {f"{k}/{p}": _f32_host(v, f"{what} {k}/{p}")
            for k in tree for p, v in tree[k].items()}


def _updater_leaves(state) -> dict:
    """``leaf_i`` arrays of an optimizer state: counts int32 scalars, every
    tensor f32."""
    out = {}
    for i, leaf in enumerate(T.state_leaves(state)):
        if isinstance(leaf, int):
            out[f"leaf_{i}"] = np.asarray(leaf, np.int32)
        else:
            out[f"leaf_{i}"] = _f32_host(leaf, f"updater leaf {i}")
    return out


def _fill_state(template, leaves, device):
    """``template`` (a fresh optimizer state) with its leaves replaced, in
    order, by ``leaves`` (numpy): the inverse of ``state_leaves``."""
    if isinstance(template, dict):
        return {k: _fill_state(v, leaves, device) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_fill_state(v, leaves, device) for v in template]
    a = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(a).reshape(template.shape).to(
            device=device, dtype=torch.float32)
    return int(a)


def _state_fits(template_leaves, saved) -> bool:
    if len(template_leaves) != len(saved):
        return False
    for t, a in zip(template_leaves, saved):
        if isinstance(t, torch.Tensor):
            if tuple(t.shape) != tuple(a.shape) or a.dtype != np.float32:
                return False
        elif a.ndim != 0 or not np.issubdtype(a.dtype, np.integer):
            return False
    return True


def checkpoint_candidates(directory: str, prefix: Optional[str] = None):
    """Checkpoint zips in ``directory``, NEWEST first — the one spelling of
    "which checkpoint do I trust". Ranked by mtime, then the
    ``checkpoint_<n>_`` counter for same-mtime files, then name. ``*.tmp``
    in-flight writes are excluded; torn files (not a readable zip) are
    skipped with a warning, never trusted."""
    if not os.path.isdir(directory):
        return []
    idx_re = re.compile(r"checkpoint_(\d+)_")

    def rank(path):
        name = os.path.basename(path)
        m = idx_re.search(name)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = 0.0
        return (mtime, int(m.group(1)) if m else -1, name)

    out = []
    for name in os.listdir(directory):
        if not name.endswith(".zip"):
            continue  # also excludes in-flight atomic writes ("x.zip.tmp")
        if prefix is not None and not name.startswith(prefix):
            continue
        path = os.path.join(directory, name)
        try:
            if zipfile.is_zipfile(path):
                out.append(path)
                continue
        except OSError:
            pass
        log.warning("skipping unreadable checkpoint %s", path)
    return sorted(out, key=rank, reverse=True)


def fsync_dir(path: str):
    """Best-effort fsync of a directory entry (after an atomic rename the
    new name is only crash-durable once the directory is synced).
    Tolerates filesystems that refuse it."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:      # not every filesystem supports directory fsync
        pass


def save_model_atomic(net, path: str, save_updater: bool = True):
    """Write-then-rename checkpoint save: a crash mid-write never leaves a
    torn zip at ``path`` — the directory holds the previous complete file
    or the new one. The tmp file is flushed and fsynced before the rename
    and the directory entry after it. The ``checkpoint.manifest`` fault
    point fires between the fsync and the rename: a crash injected there
    leaves the previous checkpoint in charge."""
    from deeplearning4j_tpu_torch.resilience import faults as _faults
    tmp = path + ".tmp"
    net.save(tmp, save_updater)
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    _faults.check("checkpoint.manifest")
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


class ModelSerializer:
    @staticmethod
    def write_model(net, path, save_updater: bool = True, normalizer=None):
        if not net._initialized:
            net.init()
        comp = getattr(net, "_grad_compression_state", None)
        comp_arrays = None
        if comp is not None:
            # the error-feedback state of the compressed exchange: the
            # residual rows of every rank, gathered (a collective when a
            # trainer placed it over several ranks: every rank calls
            # write_model, rank 0 writes the zip)
            from deeplearning4j_tpu_torch.parallel.compression import (
                state_to_arrays)
            comp_arrays = state_to_arrays(comp)
            if int(comp.get("world", 1)) > 1 and comp.get("rank", 0) != 0:
                return
        coeffs = _save_npz_bytes(**_tree_to_npz(net._params, "param"))
        states = _tree_to_npz(net._states, "state")
        upd = (_updater_leaves(net._opt_state)
               if save_updater and net._opt_state is not None else None)
        stored = zipfile.ZIP_STORED
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("configuration.json", net.conf.to_json())
            zf.writestr("coefficients.npz", coeffs, compress_type=stored)
            if states:
                zf.writestr("state.npz", _save_npz_bytes(**states),
                            compress_type=stored)
            if upd is not None:
                zf.writestr("updaterState.npz", _save_npz_bytes(**upd),
                            compress_type=stored)
            if comp_arrays is not None:
                zf.writestr("gradCompression.npz",
                            _save_npz_bytes(**comp_arrays),
                            compress_type=stored)
            if normalizer is not None:
                state = normalizer.state_dict()
                meta = {k: v for k, v in state.items()
                        if not isinstance(v, np.ndarray)}
                arrays = {k: v for k, v in state.items()
                          if isinstance(v, np.ndarray)}
                zf.writestr("normalizer.json", json.dumps(meta))
                if arrays:
                    zf.writestr("normalizer.npz", _save_npz_bytes(**arrays),
                                compress_type=stored)
            zf.writestr("meta.json", json.dumps({
                "iteration": net._iteration, "epoch": net._epoch,
                "format_version": 1,
                "framework": "deeplearning4j_tpu_torch",
                "model_type": type(net).__name__,
            }))

    writeModel = write_model

    @staticmethod
    def _restore_into(net, zf, load_updater: bool):
        """Params, states, updater state and counters into ``net`` (the
        same for both network kinds).

        Tolerant as the reference: orphaned entries are skipped with a
        warning; missing or shape-mismatched params and states keep their
        fresh value with a warning. An updater state whose leaves do not
        line up with the net's (another updater) keeps the fresh state,
        with a warning."""
        names = zf.namelist()
        net.init()
        fresh_params = net._params
        with np.load(io.BytesIO(zf.read("coefficients.npz"))) as z:
            saved = {}
            for key in z.files:
                lkey, pname = key.split("/", 1)
                saved.setdefault(lkey, {})[pname] = _read_f32(z, key,
                                                              "param")
        restored = {}
        for lkey in fresh_params:
            restored[lkey] = {}
            for pname, fresh in fresh_params[lkey].items():
                a = saved.get(lkey, {}).pop(pname, None)
                if a is None:
                    log.warning(
                        "checkpoint has no parameter %s/%s; keeping fresh "
                        "initialization", lkey, pname)
                    restored[lkey][pname] = fresh
                elif tuple(a.shape) != tuple(fresh.shape):
                    log.warning(
                        "checkpoint parameter %s/%s has shape %s but the "
                        "model expects %s; keeping fresh initialization",
                        lkey, pname, tuple(a.shape), tuple(fresh.shape))
                    restored[lkey][pname] = fresh
                else:
                    restored[lkey][pname] = a
        for lkey, rest in saved.items():
            for pname in rest:
                log.warning(
                    "ignoring orphaned checkpoint parameter %s/%s (saved by "
                    "an older architecture, e.g. a conv bias from before "
                    "has_bias=False)", lkey, pname)
        net.set_param_tree(restored)
        if "state.npz" in names:
            with np.load(io.BytesIO(zf.read("state.npz"))) as z:
                states = {}
                for key in z.files:
                    lkey, sname = key.split("/", 1)
                    states.setdefault(lkey, {})[sname] = _read_f32(z, key,
                                                                   "state")
            merged = {}
            for lkey in net._states:
                merged[lkey] = {}
                for sname, fresh in net._states[lkey].items():
                    a = states.get(lkey, {}).get(sname)
                    if a is not None and tuple(a.shape) == tuple(fresh.shape):
                        merged[lkey][sname] = a
                    else:
                        log.warning(
                            "checkpoint state %s/%s missing or mismatched; "
                            "keeping fresh value", lkey, sname)
                        merged[lkey][sname] = fresh
            net.set_state_tree(merged)
        if load_updater and "updaterState.npz" in names:
            with np.load(io.BytesIO(zf.read("updaterState.npz"))) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            template = T.state_leaves(net._opt_state)
            if _state_fits(template, leaves):
                net._opt_state = _fill_state(net._opt_state, iter(leaves),
                                             net.device)
            else:
                log.warning(
                    "checkpoint updater state (%d leaves) does not fit the "
                    "model's updater (%d leaves); keeping fresh state",
                    len(leaves), len(template))
        if "gradCompression.npz" in names:
            # the global (n_replicas, size) residuals and the thresholds; a
            # ShardedTrainer hands each rank its row at placement, or
            # reshapes them to another replica count
            from deeplearning4j_tpu_torch.parallel.compression import (
                state_from_arrays)
            with np.load(io.BytesIO(zf.read("gradCompression.npz"))) as z:
                net._grad_compression_state = state_from_arrays(
                    {k: z[k] for k in z.files})
        if "meta.json" in names:
            meta = json.loads(zf.read("meta.json"))
            net._iteration = meta.get("iteration", 0)
            net._epoch = meta.get("epoch", 0)
        return net

    @staticmethod
    def restore_multi_layer_network(path, load_updater: bool = True,
                                    device=None):
        from deeplearning4j_tpu_torch.nn.conf.configuration import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        with zipfile.ZipFile(path, "r") as zf:
            # "coefficients.bin": a DL4J artifact (Jackson JSON + Nd4j.write
            # binary) for the compat reader
            if "coefficients.bin" not in zf.namelist():
                conf = MultiLayerConfiguration.from_json(
                    zf.read("configuration.json").decode())
                return ModelSerializer._restore_into(
                    MultiLayerNetwork(conf, device=device), zf, load_updater)
        from deeplearning4j_tpu_torch.modelimport import dl4j_zip
        return dl4j_zip.restore_multi_layer_network(path, device=device)

    restoreMultiLayerNetwork = restore_multi_layer_network

    @staticmethod
    def restore_computation_graph(path, load_updater: bool = True,
                                  device=None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.graph_conf import (
            ComputationGraphConfiguration)
        with zipfile.ZipFile(path, "r") as zf:
            if "coefficients.bin" not in zf.namelist():
                conf = ComputationGraphConfiguration.from_json(
                    zf.read("configuration.json").decode())
                return ModelSerializer._restore_into(
                    ComputationGraph(conf, device=device), zf, load_updater)
        from deeplearning4j_tpu_torch.modelimport import dl4j_zip
        return dl4j_zip.restore_computation_graph(path, device=device)

    restoreComputationGraph = restore_computation_graph

    @staticmethod
    def restore(path, load_updater: bool = True, device=None):
        """Dispatch on ``meta.json``'s model_type; a DL4J artifact carries
        no meta.json, so there a ``vertices`` map in its configuration
        means a graph."""
        with zipfile.ZipFile(path, "r") as zf:
            names = zf.namelist()
            meta = (json.loads(zf.read("meta.json")) if "meta.json" in names
                    else {})
            is_cg = meta.get("model_type") == "ComputationGraph"
            if not meta and "configuration.json" in names:
                try:
                    is_cg = "vertices" in json.loads(
                        zf.read("configuration.json"))
                except ValueError:
                    pass
        if is_cg:
            return ModelSerializer.restore_computation_graph(
                path, load_updater, device=device)
        return ModelSerializer.restore_multi_layer_network(
            path, load_updater, device=device)

    @staticmethod
    def restore_normalizer(path):
        from deeplearning4j_tpu_torch.data.normalizers import NORMALIZERS
        with zipfile.ZipFile(path, "r") as zf:
            if "normalizer.json" not in zf.namelist():
                return None
            meta = json.loads(zf.read("normalizer.json"))
            arrays = {}
            if "normalizer.npz" in zf.namelist():
                with np.load(io.BytesIO(zf.read("normalizer.npz"))) as z:
                    arrays = {k: z[k] for k in z.files}
        norm = NORMALIZERS[meta.pop("type")]()
        norm.load_state_dict({**meta, **arrays})
        return norm

    restoreNormalizer = restore_normalizer
