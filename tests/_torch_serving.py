"""Shared pieces of the port's serving-plane tests (``test_torch_serving``,
``test_torch_frontdoor``, ``test_torch_fleet``, ``test_torch_sessions``,
``test_torch_watchtower``).

Both packages serve the same tiny f32 ``TransformerLM`` — the reference
demo's shape (vocab 61, 2 layers, 2 heads of 16, d_model 32, decoding to
48 tokens) — with the JAX weights crossing into the port by
``from_jax_params``. :data:`JAX` and :data:`TORCH` name each package's
serving modules, so a test runs one scenario through both and compares.
Every HTTP call goes through ``chip_smoke``'s client (``http_call``,
``SseClient``) and has a socket timeout.
"""
from __future__ import annotations

import types

import numpy as np

import jax

import deeplearning4j_tpu.observability as j_obs
import deeplearning4j_tpu.parallel.generation as j_pgen
import deeplearning4j_tpu.resilience.faults as j_faults
import deeplearning4j_tpu.serving as j_serving
import deeplearning4j_tpu.serving.frontdoor as j_frontdoor
import deeplearning4j_tpu.serving.idempotency as j_idem
import deeplearning4j_tpu.serving.registry as j_registry
import deeplearning4j_tpu.serving.rollout as j_rollout
import deeplearning4j_tpu.serving.router as j_router
import deeplearning4j_tpu.serving.session as j_sess
import deeplearning4j_tpu.serving.shared_state as j_shared
from deeplearning4j_tpu.models import generation as jgen
from deeplearning4j_tpu.models import transformer as jtr

import deeplearning4j_tpu_torch.observability as t_obs
import deeplearning4j_tpu_torch.parallel.generation as t_pgen
import deeplearning4j_tpu_torch.resilience.faults as t_faults
import deeplearning4j_tpu_torch.serving as t_serving
import deeplearning4j_tpu_torch.serving.frontdoor as t_frontdoor
import deeplearning4j_tpu_torch.serving.idempotency as t_idem
import deeplearning4j_tpu_torch.serving.registry as t_registry
import deeplearning4j_tpu_torch.serving.rollout as t_rollout
import deeplearning4j_tpu_torch.serving.router as t_router
import deeplearning4j_tpu_torch.serving.session as t_sess
import deeplearning4j_tpu_torch.serving.shared_state as t_shared
from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import from_jax_params

from chip_smoke import SseClient, http_call

VOCAB = 61
KW = dict(vocab_size=VOCAB, n_layers=2, n_heads=2, d_model=32, max_len=64)
MAXLEN = 48
#: bound on every HTTP call and every join in these tests
TIMEOUT_S = 60.0

JAX = types.SimpleNamespace(
    name="jax", serving=j_serving, frontdoor=j_frontdoor, idem=j_idem,
    registry=j_registry, rollout=j_rollout, router=j_router, sess=j_sess,
    shared=j_shared, faults=j_faults, obs=j_obs, pgen=j_pgen)
TORCH = types.SimpleNamespace(
    name="torch", serving=t_serving, frontdoor=t_frontdoor, idem=t_idem,
    registry=t_registry, rollout=t_rollout, router=t_router, sess=t_sess,
    shared=t_shared, faults=t_faults, obs=t_obs, pgen=t_pgen)
BOTH = (JAX, TORCH)

_CACHE = {}


def _models():
    if "m" not in _CACHE:
        jm = jtr.TransformerLM(jtr.TransformerConfig(**KW))
        jp = jm.init_params(jax.random.key(0))
        cfg = ttr.TransformerConfig(**KW)
        tm = ttr.TransformerLM(cfg, device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")
        _CACHE["m"] = (jm, jp, tm, tp)
    return _CACHE["m"]


def engine(pkg, **kw):
    """The package's demo ``DecodeEngine`` over the shared weights, one a
    (package, kwargs) for the module (the JAX jit caches live on it)."""
    key = (pkg.name, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jm, jp, tm, tp = _models()
        if pkg is JAX:
            _CACHE[key] = jgen.DecodeEngine(jm, jp, max_len=MAXLEN, **kw)
        else:
            _CACHE[key] = tgen.DecodeEngine(tm, tp, max_len=MAXLEN,
                                            device="cpu", **kw)
    return _CACHE[key]


def greedy(prompt, n):
    """The JAX engine's greedy tokens for ``prompt`` alone."""
    return np.asarray(engine(JAX).generate(
        np.asarray(prompt, np.int32)[None], n))[0].tolist()


def prompt(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (n,)).astype(np.int32)


def reset_all():
    """Fresh registries, fault plans and session tables in both packages."""
    for pkg in BOTH:
        pkg.faults.reset()
        pkg.obs.reset_global_registry()
        pkg.sess.reset_for_tests()
        pkg.idem.reset_global_journal()


def teardown_all():
    """Stop every door, registry and pipeline a test left behind (each
    test stops its own in a ``finally``; this is the fixture's net)."""
    for pkg in BOTH:
        pkg.faults.clear()
        for fd in list(pkg.frontdoor.FrontDoor._live):
            fd.stop()
        for reg in list(pkg.registry.ModelRegistry._live):
            reg.shutdown(drain_timeout_s=TIMEOUT_S)
        pkg.pgen.GenerationPipeline.shutdown_all()
        pkg.sess.reset_for_tests()


def get(addr, path, timeout=TIMEOUT_S):
    """(status, JSON body) of one GET, through chip_smoke's client."""
    return http_call(addr, path, timeout=timeout)[:2]


def sse(addr, doc, headers=None, timeout=TIMEOUT_S):
    """One streamed generate through chip_smoke's SSE client: (ids,
    tokens, done, error, events, headers), ``events`` every (event,
    data) pair in wire order, ``headers`` the response's."""
    c = SseClient(addr, doc, headers=headers, timeout=timeout)
    c.run()
    if c.exc is not None:
        raise c.exc
    assert c.headers["Content-Type"].startswith("text/event-stream")
    return c.ids, c.toks, c.done, c.error, c.events, c.headers


def strip_volatile(doc, keys=("worker", "session", "trace_id")):
    """A response body without the fields that name a process, a minted
    session id or a trace id (they differ between any two doors)."""
    if isinstance(doc, dict):
        return {k: strip_volatile(v, keys) for k, v in doc.items()
                if k not in keys}
    if isinstance(doc, list):
        return [strip_volatile(v, keys) for v in doc]
    return doc
