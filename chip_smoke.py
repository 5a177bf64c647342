#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``kernels/csrc/`` with
``nvcc`` (one process per source, all at once), checks in ptxas's report
that the wgmma forward has 168 registers a thread at entry and no spills
and that the wgmma backward's kernels spill nothing, then:

1. kernel phase — holds each flash-attention kernel (the wgmma kernel for
   bf16 at d 64/128, the simple kernel for f32 and the other head dims)
   against its plain PyTorch version on the card, at the main path's
   shapes and layouts (the strided fused-QKV views, the batch bucket, the
   ragged ``apply`` length, block edges, non-causal with Tq != Tk, d 128),
   and times each: ``ms`` (20 back-to-back wrapper calls between CUDA
   events, host included), ``device_ms`` (20 launches captured in a CUDA
   graph, replays timed with CUDA events: device only), the plain
   version, SDPA (``library_ms`` and ``library_device_ms``, timed the same
   two ways) and the card's bound;
2. backward phase — holds each backward kernel (K2: dq, dk, dv; the wgmma
   backward for bf16 at d 64/128, the ``mma.sync`` one for f32 and the
   other head dims) against its plain version at the training layer (fused
   QKV views, batch 8), ragged and block-edge lengths, Tq != Tk, d 128, f32
   and the other head dims, and times it as the forward is, plus the
   forward and backward together (K1 + K2) against SDPA's forward and
   backward, and SDPA's backward alone (its forward and backward less its
   forward); each gradient is held by its largest error and by the
   relative L2 error of each 64-row tile;
   then the training step's tied LM head (bf16 product into f32 logits,
   bf16 dlogits in its backward) against autograd through the f32 product
   at the training layer;
3. slice phase — serves generation from ``TransformerLM`` at the full
   width of the bench's large config (vocab 32768, 12 layers, 16 heads,
   d_model 1024, d_ff 4096, max_len 1024, bf16, fused QKV; random weights
   from a numpy seed through ``from_jax_params``) through ``DecodeEngine``
   in its default paged mode, checks the tokens and logits, and checks that
   every prefill and ``apply`` launched the wgmma kernel exactly once per
   layer and the simple kernel never;
4. profile phase — one ``torch.profiler`` window over a single prefill at
   bucket 1024: the device's busy share and the top device kernels;
5. training phase — ``make_train_step(adamw(3e-4))`` at the same config,
   batch 8 × 1024 tokens (bench.py's first rung): 2 warm and 5 timed steps
   on one batch (ms per step, tokens/s, MFU by bench.py's count, peak
   memory), a falling finite loss, the wgmma forward and the wgmma
   backward launched once per layer per step and the simple forward and
   the ``mma.sync`` backward never; then one gradient on the kernels
   against one on their plain versions, and a profiler window over one
   step.

Every phase must pass: any failure exits nonzero. Output is one JSON
object per line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or outside a checkout, it exits nonzero and prints no result.

``python3 chip_smoke.py --compare-bwd OTHER`` instead times K2 (and K1 at
its main shapes) in this tree and in the checkout at OTHER in turns
(OTHER, this, this, OTHER), each turn a subprocess running that tree's
``kernel_phase`` and ``bwd_phase`` on the bf16 d 64/128 cases, and prints
each case's device ms per turn.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
N_NEW = 32
PROMPT_LENS = (960, 500, 200, 37)       # buckets 1024, 512, 256, 64
PROFILE_PROMPT = 960                    # bucket 1024
ROOT = Path(__file__).resolve().parent
# where the profile phase writes its Chrome trace (gitignored)
OUT_DIR = ROOT / "deeplearning4j_tpu_torch" / "_build"
# Kernel cases: (layout, B, H, Tq, Tk, d, dtype, causal). "fused" is the
# (B, H, T, d) views of one (B, T, 3·H·d) projection with o written into
# the (B, H, T, d) view of a (B, T, H, d) buffer, as TransformerLM._attn
# calls the wrapper; "3d" is contiguous (B·H, T, d) (H = 1).
KERNEL_CASES = [
    # the main path: prefill buckets (B 1, 16 heads, d 64) and the batch
    ("fused", 1, 16, 1024, 1024, 64, "bfloat16", True),
    ("fused", 1, 16, 512, 512, 64, "bfloat16", True),
    ("fused", 1, 16, 256, 256, 64, "bfloat16", True),
    ("fused", 1, 16, 64, 64, 64, "bfloat16", True),
    ("fused", 4, 16, 128, 128, 64, "bfloat16", True),
    ("fused", 1, 16, 991, 991, 64, "bfloat16", True),    # apply, ragged
    # block edges
    ("fused", 1, 16, 127, 127, 64, "bfloat16", True),
    ("fused", 1, 16, 129, 129, 64, "bfloat16", True),
    ("fused", 1, 16, 1, 1, 64, "bfloat16", True),
    # contiguous (B·H, T, d)
    ("3d", 16, 1, 1024, 1024, 64, "bfloat16", True),
    ("3d", 64, 1, 512, 512, 64, "bfloat16", True),
    ("3d", 16, 1, 1000, 1000, 64, "bfloat16", True),
    ("3d", 16, 1, 1024, 1024, 64, "bfloat16", False),
    # the training layer (bench large config, batch 8)
    ("fused", 8, 16, 1024, 1024, 64, "bfloat16", True),
    # non-causal with Tq != Tk
    ("3d", 16, 1, 512, 1024, 64, "bfloat16", False),
    ("fused", 2, 16, 300, 77, 64, "bfloat16", False),
    # d 128
    ("3d", 16, 1, 512, 512, 128, "bfloat16", True),
    ("fused", 1, 8, 1024, 1024, 128, "bfloat16", True),
    # the simple kernel: f32, and bf16 at other head dims
    ("3d", 16, 1, 256, 256, 64, "float32", True),
    ("fused", 1, 16, 1024, 1024, 64, "float32", True),
    ("3d", 16, 1, 512, 512, 32, "bfloat16", True),
    ("fused", 1, 8, 129, 129, 80, "bfloat16", True),
]
MAIN_CASE = {"wgmma": ("fused", 1, 16, 1024, 1024, 64, "bfloat16", True),
             "simple": ("3d", 16, 1, 256, 256, 64, "float32", True)}
SOURCES = {"wgmma": "flash_attention_fwd_wgmma.cu",
           "simple": "flash_attention_fwd.cu",
           "bwd_wgmma": "flash_attention_bwd_wgmma.cu",
           "bwd": "flash_attention_bwd.cu"}
# the launch counters of the four kernels, in the order counts() gives them
KERNELS = ("wgmma", "simple", "bwd_wgmma", "bwd")
# K2 (backward) cases, laid out as KERNEL_CASES: "fused" takes q, k, v from
# one (B, T, 3·H·d) projection, o from the forward written as TransformerLM
# writes it, dO as the (B, H, T, d) view of a (B, T, H·d) gradient, and
# writes dq, dk, dv into the views of (B, T, 3·H·d) gradient buffers
BWD_CASES = [
    ("fused", 8, 16, 1024, 1024, 64, "bfloat16", True),   # the training layer
    ("fused", 1, 16, 991, 991, 64, "bfloat16", True),     # ragged
    ("fused", 1, 16, 127, 127, 64, "bfloat16", True),     # block edges
    ("fused", 1, 16, 129, 129, 64, "bfloat16", True),
    ("fused", 1, 16, 1, 1, 64, "bfloat16", True),
    ("fused", 2, 16, 300, 77, 64, "bfloat16", False),     # Tq != Tk
    ("fused", 1, 8, 1024, 1024, 128, "bfloat16", True),   # d 128
    ("3d", 16, 1, 256, 256, 64, "float32", True),
    ("3d", 16, 1, 512, 512, 32, "bfloat16", True),
    ("fused", 1, 8, 129, 129, 80, "bfloat16", True),
]
BWD_MAIN_CASE = {"bwd_wgmma": BWD_CASES[0], "bwd": BWD_CASES[7]}
# the bench's large config (bench.py, the "large" rung)
LARGE = dict(vocab_size=32768, n_layers=12, n_heads=16, d_model=1024,
             d_ff=4096, max_len=1024, dtype="bfloat16", fused_qkv=True)
# tolerances (PERF.md states the reasons): kernel vs plain version on the
# same inputs, and decode logits vs the full forward over the same tokens
TOL_O = {"bfloat16": 2e-2, "float32": 5e-5}
TOL_LSE = 1e-3
TOL_TEACHER_FORCED = 0.1
# K2 vs its plain version: max |dg| over max(1, max |g_plain|) per gradient,
# and the relative L2 error of each 64-row tile along T of each gradient
# (its norm floored at an rms of GRAD_RMS_FLOOR, so a tile that cancels to
# ~0 is held to an absolute error); one full-width gradient on the kernels
# vs on the plain versions: |dloss|, and each leaf's relative L2 error
TOL_GRAD = {"bfloat16": 1e-2, "float32": 1e-5}
TOL_GRAD_TILE_L2 = {"bfloat16": 1e-3, "float32": 5e-7}
GRAD_RMS_FLOOR = {"bfloat16": 1e-3, "float32": 1e-6}
TOL_STEP_LOSS = 5e-5
TOL_STEP_LEAF = 1.5e-2
# the tied LM head on the card (bf16 operands, f32 logits, bf16 dlogits in
# its backward) vs autograd through the f32 product, at the training layer:
# relative L2 error of the logits and of each gradient
TOL_HEAD = {"logits": 5e-6, "dx": 5e-3, "de": 5e-3}
# the training phase: bench.py's first rung of the large config
TRAIN_BATCH = 8
WARM_STEPS = 2
TIMED_STEPS = 5
LEARNING_RATE = 3e-4
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA
# (no TF32 in the port), device memory bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the wgmma kernel's 384 threads: ptxas must budget 168 registers a thread
# at entry, which its setmaxnreg 24 / 240 split balances to the register
WGMMA_ENTRY_REGISTERS = 168
# the profile phase fails when the trace holds no device work; only a CPU
# rehearsal of the phase sets this to False
TRACE_ON_DEVICE = True


def emit(**kv):
    print(json.dumps(kv), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, torch, iters=20, repeats=7):
    """Median over ``repeats`` of CUDA-event time per call of ``fn``, the
    host's work for each call included (back-to-back Python calls)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def device_ms(fn, torch, launches=20, repeats=7):
    """Device time per call of ``fn``: ``launches`` calls captured into one
    CUDA graph, the median over ``repeats`` replays timed with CUDA events.
    The host's work runs once, at capture, so it is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(times)


def _kept_pairs(t_q, t_k, causal):
    """(query, key) pairs attention computes: all of them, or causally
    only k_idx <= q_idx."""
    return (sum(min(i + 1, t_k) for i in range(t_q)) if causal
            else t_q * t_k)


def _bound(flops, nbytes, dtype):
    t_ops, t_mem = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def attention_bound_ms(bh, t_q, t_k, d, dtype, causal):
    """Least time for one call: the larger of its FLOPs over the peak
    rate of its type and its bytes (q, k, v read once, o and lse written
    once) over the memory rate. Causal counts only the kept pairs
    (k_idx <= q_idx)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * bh * d * _kept_pairs(t_q, t_k, causal)
    nbytes = itemsize * bh * d * 2 * (t_q + t_k) + 4 * bh * t_q
    return _bound(flops, nbytes, dtype)


def attention_bwd_bound_ms(bh, t_q, t_k, d, dtype, causal):
    """Least time for one backward call: the five products of
    ``_bwd_blockwise`` (S = QKᵀ, dV = PᵀdO, dP = dO·Vᵀ, dQ = dS·K,
    dK = dSᵀQ), 2·d FLOPs per kept pair each, over the peak rate of the
    type, against q, k, v, o, dO and lse read once and dq, dk, dv written
    once over the memory rate."""
    itemsize = 2 if dtype == "bfloat16" else 4
    flops = 10.0 * bh * d * _kept_pairs(t_q, t_k, causal)
    nbytes = itemsize * bh * d * 4 * (t_q + t_k) + 4 * bh * t_q
    return _bound(flops, nbytes, dtype)


def tile_rel_l2(x, ref, rms_floor, rows=64):
    """The largest relative L2 error of ``x`` against ``ref`` over tiles of
    ``rows`` rows along dim -2 (T for an attention gradient), each tile's
    norm floored at ``rms_floor`` times the root of its size."""
    worst = 0.0
    for a, b in zip(x.float().split(rows, dim=-2),
                    ref.float().split(rows, dim=-2)):
        den = max(b.norm().item(), rms_floor * math.sqrt(b.numel()))
        worst = max(worst, (a - b).norm().item() / den)
    return worst


def train_flops_per_token(n_params, n_layers, seq_len, d_model):
    """bench.py's count for a causal LM's training step: 6·N for the
    forward and backward through the params, plus 6·L·T·d for attention."""
    return 6 * n_params + 6 * n_layers * seq_len * d_model


def case_inputs(torch, case):
    """q, k, v, an output view (or None) and SDPA's 4-D q, k, v."""
    layout, b, h, t_q, t_k, d, dtype, _causal = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(
        b * 1000003 + h * 10007 + t_q * 101 + t_k + d)
    if layout == "3d":
        q = torch.randn((b, t_q, d), generator=g, device="cuda", dtype=dt)
        k, v = (torch.randn((b, t_k, d), generator=g, device="cuda",
                            dtype=dt) for _ in range(2))
        return q, k, v, None, (q[None], k[None], v[None])
    c = h * d
    xq = torch.randn((b, t_q, 3 * c), generator=g, device="cuda", dtype=dt)
    xk = (xq if t_k == t_q else
          torch.randn((b, t_k, 3 * c), generator=g, device="cuda", dtype=dt))
    q = xq[..., :c].reshape(b, t_q, h, d).transpose(1, 2)
    k = xk[..., c:2 * c].reshape(b, t_k, h, d).transpose(1, 2)
    v = xk[..., 2 * c:].reshape(b, t_k, h, d).transpose(1, 2)
    out = torch.empty((b, t_q, h, d), device="cuda", dtype=dt).transpose(1, 2)
    return q, k, v, out, (q, k, v)


def _ptxas(log, entry, key):
    """{key(match): {"registers": n, "spill_bytes": stores + loads}} for
    each kernel entry whose mangled name matches the regex ``entry`` in a
    ptxas report (``-Xptxas -v``)."""
    report, k = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(entry, line)
            k = key(m) if m else None
            if k is not None:
                report[k] = {}
            continue
        if k is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[k]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[k]["registers"] = int(m.group(1))
    return report


def wgmma_ptxas(log):
    """{head dim: {"registers": n, "spill_bytes": n}} for each
    instantiation of the wgmma forward."""
    return _ptxas(log, r"flash_fwd_wgmma_kernelILi(\d+)E",
                  lambda m: int(m.group(1)))


def serialized_wgmma(log):
    """ptxas's warnings that it serialized wgmma (C7514, C7512: issue or
    wait counts it cannot prove), which cost the overlap a kernel is built
    around."""
    return [ln.strip() for ln in log.splitlines()
            if "C7514" in ln or "C7512" in ln]


def bwd_wgmma_ptxas(log):
    """{"d64 dq": {"registers": n, "spill_bytes": n}, ...} for each
    instantiation of the wgmma backward: the dQ kernel and the dK/dV kernel
    at each head dim."""
    return _ptxas(log, r"flash_bwd_wgmma_kernelILi(\d+)ELb([01])E",
                  lambda m: f"d{m.group(1)} "
                  + ("dkdv" if m.group(2) == "1" else "dq"))


def kernel_phase(torch, fa):
    """Both flash kernels against their plain version at each case."""
    import torch.nn.functional as F
    # about a second of matmuls first, so the first case is not timed while
    # the card's clocks are still coming up
    x = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    end = time.perf_counter() + 1.0
    while time.perf_counter() < end:
        x @ x
        torch.cuda.synchronize()
    results = {}
    for case in KERNEL_CASES:
        layout, b, h, t_q, t_k, d, dtype, causal = case
        q, k, v, out, (q4, k4, v4) = case_inputs(torch, case)
        path = "wgmma" if fa.takes_wgmma(q.dtype, d) else "simple"
        fa.launches_wgmma = fa.launches_simple = 0
        o, lse = fa.flash_attention_fwd(q, k, v, causal, out=out)
        torch.cuda.synchronize()
        check((fa.launches_wgmma, fa.launches_simple)
              == ((1, 0) if path == "wgmma" else (0, 1)),
              f"{case}: launched ({fa.launches_wgmma}, "
              f"{fa.launches_simple}), want only the {path} kernel")
        check(out is None or o.data_ptr() == out.data_ptr(),
              f"{case}: o not written into the caller's view")
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err_o) and err_o <= TOL_O[dtype],
              f"flash_attention_fwd {case}: max |do| {err_o} > "
              f"{TOL_O[dtype]}")
        check(math.isfinite(err_lse) and err_lse <= TOL_LSE,
              f"flash_attention_fwd {case}: max |dlse| {err_lse} > "
              f"{TOL_LSE}")

        def kernel():
            fa.flash_attention_fwd(q, k, v, causal, out=out)

        def library():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

        ms = time_ms(kernel, torch)
        dev_ms = device_ms(kernel, torch)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal), torch,
            iters=5, repeats=5)
        library_ms = time_ms(library, torch)
        library_dev_ms = device_ms(library, torch)
        bound_ms, bound_by = attention_bound_ms(b * h, t_q, t_k, d, dtype,
                                                causal)
        row = {"path": path, "layout": layout, "b": b, "h": h, "t_q": t_q,
               "t_k": t_k, "d": d, "dtype": dtype, "causal": causal,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_device_ms": library_dev_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "device_vs_library": dev_ms / library_dev_ms,
               "device_vs_bound": dev_ms / bound_ms}
        emit(kernel_case=row)
        results[case] = row
    return results


def bwd_case_inputs(torch, fa, case):
    """The forward's inputs and output (as :func:`case_inputs`, o and lse
    from the kernel), dO, three views that receive dq, dk, dv, and SDPA's
    4-D q, k, v and dO. "fused": dO is the (B, H, T, d) view of a (B, T,
    H·d) gradient and the views are the column blocks of (B, T, 3·H·d)
    gradient buffers, as ``fa.FlashAttention`` calls the wrapper."""
    layout, b, h, t_q, t_k, d, dtype, causal = case
    q, k, v, out, sdpa = case_inputs(torch, case)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out=out)
    g = torch.Generator(device="cuda").manual_seed(t_q * 7919 + t_k + d)
    if layout == "3d":
        do = torch.randn(q.shape, generator=g, device="cuda", dtype=q.dtype)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        return q, k, v, out, o, lse, do, grads, (*sdpa, do[None])
    c = h * d
    do = torch.randn((b, t_q, c), generator=g, device="cuda",
                     dtype=q.dtype).view(b, t_q, h, d).transpose(1, 2)
    gq = torch.empty((b, t_q, 3 * c), device="cuda", dtype=q.dtype)
    gk = gq if t_k == t_q else torch.empty((b, t_k, 3 * c), device="cuda",
                                           dtype=q.dtype)
    grads = tuple(x[..., i * c:(i + 1) * c].reshape(b, x.shape[1], h, d)
                  .transpose(1, 2) for i, x in enumerate((gq, gk, gk)))
    return q, k, v, out, o, lse, do, grads, (*sdpa, do)


def bwd_phase(torch, fa):
    """K2 against its plain version at each of BWD_CASES, timed as the
    forward is, plus the forward and backward together (K1 + K2) against
    SDPA's forward and backward on the same inputs, and SDPA's backward
    alone as the difference of its forward and backward and its forward
    (both device times of this call, the forward run as training runs it,
    on leaves that require grad)."""
    import torch.nn.functional as F
    results = {}
    for case in BWD_CASES:
        layout, b, h, t_q, t_k, d, dtype, causal = case
        (q, k, v, out, o, lse, do, grads,
         (q4, k4, v4, do4)) = bwd_case_inputs(torch, fa, case)
        path = ("bwd_wgmma" if fa.takes_wgmma_bwd(q.dtype, d) else "bwd")
        fa.launches_bwd = fa.launches_bwd_wgmma = 0
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, out=grads)
        torch.cuda.synchronize()
        launched = (fa.launches_bwd_wgmma, fa.launches_bwd)
        check(launched == ((1, 0) if path == "bwd_wgmma" else (0, 1))
              and all(x is y for x, y in zip(got, grads)),
              f"bwd {case}: launched (wgmma, mma.sync) {launched}, want only "
              f"{path}, or did not write into the caller's views")
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        errs, tile_l2 = {}, {}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            err = (x.float() - r.float()).abs().max().item()
            limit = TOL_GRAD[dtype] * max(1.0, r.float().abs().max().item())
            check(math.isfinite(err) and err <= limit,
                  f"flash_attention_bwd {case}: max |d{name}| {err} > "
                  f"{limit}")
            errs[name] = err
            tile_l2[name] = tile_rel_l2(x, r, GRAD_RMS_FLOOR[dtype])
            check(tile_l2[name] <= TOL_GRAD_TILE_L2[dtype],
                  f"flash_attention_bwd {case}: a 64-row tile of {name} has "
                  f"relative L2 error {tile_l2[name]} > "
                  f"{TOL_GRAD_TILE_L2[dtype]}")
        del ref

        def kernel():
            fa.flash_attention_bwd(q, k, v, o, lse, do, causal, out=grads)

        def pair():
            o_, lse_ = fa.flash_attention_fwd(q, k, v, causal, out=out)
            fa.flash_attention_bwd(q, k, v, o_, lse_, do, causal, out=grads)

        def library():
            # fresh leaves each call, so autograd's accumulation nodes are
            # made on the stream being captured
            xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            y = F.scaled_dot_product_attention(*xs, is_causal=causal)
            torch.autograd.grad(y, xs, do4)

        def library_fwd():
            xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            F.scaled_dot_product_attention(*xs, is_causal=causal)

        bound_ms, bound_by = attention_bwd_bound_ms(b * h, t_q, t_k, d,
                                                    dtype, causal)
        row = {"path": path, "layout": layout, "b": b, "h": h, "t_q": t_q,
               "t_k": t_k, "d": d, "dtype": dtype, "causal": causal,
               "max_abs_err": errs, "max_tile_rel_l2": tile_l2,
               "ms": time_ms(kernel, torch),
               "device_ms": device_ms(kernel, torch),
               "plain_ms": time_ms(lambda: fa.flash_attention_bwd_reference(
                   q, k, v, o, lse, do, causal), torch, iters=3, repeats=3),
               "fwd_bwd_ms": time_ms(pair, torch),
               "fwd_bwd_device_ms": device_ms(pair, torch),
               "library_ms": time_ms(library, torch),
               "library_device_ms": device_ms(library, torch),
               "library_fwd_device_ms": device_ms(library_fwd, torch),
               "bound_ms": bound_ms, "bound_by": bound_by}
        # a difference of two device times, not a direct reading
        row["library_bwd_device_ms"] = (row["library_device_ms"]
                                        - row["library_fwd_device_ms"])
        row["device_vs_bound"] = row["device_ms"] / bound_ms
        row["device_vs_library_bwd"] = (row["device_ms"]
                                        / row["library_bwd_device_ms"])
        row["fwd_bwd_vs_library"] = (row["fwd_bwd_device_ms"]
                                     / row["library_device_ms"])
        emit(bwd_case=row)
        results[case] = row
    return results


def head_phase(torch):
    """The tied LM head of the training step (``_TiedHead``: bf16 x and e,
    f32 logits, bf16 dlogits in the backward) against autograd through the
    f32 product ``x.float() @ e.float().T`` on the same inputs: x (8, 1024,
    1024) at a LayerNorm's scale, e (32768, 1024) at the init's, and the
    cross-entropy gradient of random targets as dlogits. Also gives how far
    JAX's ``ce_chunks=0`` gradient arithmetic (f32 dlogits, f32 products,
    each gradient rounded to bf16) lies from the f32 one, beside the
    head's."""
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.models.transformer import _TiedHead
    resolve_device()            # TF32 off: the reference product is f32
    b, t, c, vocab = (TRAIN_BATCH, LARGE["max_len"], LARGE["d_model"],
                      LARGE["vocab_size"])
    n = b * t
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn((b, t, c), generator=g, device="cuda").bfloat16()
    e = (0.02 * torch.randn((vocab, c), generator=g, device="cuda")
         ).bfloat16()
    xr, er = (a.float().requires_grad_() for a in (x, e))
    logits_ref = torch.matmul(xr, er.T)
    targets = torch.randint(0, vocab, (n,), generator=g, device="cuda")
    with torch.no_grad():
        dlogits = torch.softmax(logits_ref, -1)
        dlogits.view(n, vocab)[torch.arange(n, device="cuda"),
                               targets] -= 1.0
        dlogits /= n
    dx_ref, de_ref = torch.autograd.grad(logits_ref, (xr, er), dlogits)
    xk, ek = (a.detach().requires_grad_() for a in (x, e))
    logits = _TiedHead.apply(xk, ek)
    dx, de = torch.autograd.grad(logits, (xk, ek), dlogits)
    torch.cuda.synchronize()
    check(logits.dtype == torch.float32 and dx.dtype == de.dtype
          == torch.bfloat16, f"head dtypes {logits.dtype} {dx.dtype} "
          f"{de.dtype}")

    def rel(got, want):
        return ((got.float() - want).norm() / want.norm()).item()

    check(logits.shape == (b, t, vocab), f"head logits {logits.shape}")
    row = {"logits": rel(logits, logits_ref.detach()), "dx": rel(dx, dx_ref),
           "de": rel(de, de_ref)}
    row["jax_ce_chunks0_arithmetic"] = {
        "dx": rel(dx_ref.bfloat16(), dx_ref), "de": rel(de_ref.bfloat16(),
                                                        de_ref)}
    row["head_vs_jax_arithmetic"] = {"dx": rel(dx, dx_ref.bfloat16().float()),
                                     "de": rel(de, de_ref.bfloat16().float())}
    emit(head={"batch": b, "seq_len": t, "d_model": c, "vocab": vocab,
               "rel_l2": row, "tolerance": TOL_HEAD})
    for name, limit in TOL_HEAD.items():
        check(math.isfinite(row[name]) and row[name] <= limit,
              f"tied head: relative L2 error of {name} {row[name]} > {limit}")


def counts(fa):
    """Launches of each flash kernel, in the order of KERNELS: (wgmma
    forward, simple forward, wgmma backward, mma.sync backward)."""
    return (fa.launches_wgmma, fa.launches_simple, fa.launches_bwd_wgmma,
            fa.launches_bwd)


def reset_counts(fa):
    fa.launches_wgmma = fa.launches_simple = 0
    fa.launches_bwd_wgmma = fa.launches_bwd = 0


def slice_phase(torch, fa):
    """Full-width generation through the port's entry points. Returns the
    engine, the model and each kernel's launches in the run."""
    from deeplearning4j_tpu_torch.models.generation import (DecodeEngine,
                                                            SamplerConfig)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    from deeplearning4j_tpu_torch.tree import tree_leaves

    cfg = TransformerConfig(**LARGE)
    t0 = time.perf_counter()
    params = from_jax_params(init_jax_layout(cfg, SEED), cfg)
    model = TransformerLM(cfg)
    engine = DecodeEngine(model, params, max_len=1024)
    check(engine.paged and engine.page_tokens == 64,
          f"engine is not in its default paged mode ({engine.page_tokens})")
    engine.warm(1)
    torch.cuda.synchronize()
    emit(setup={"params": sum(p.numel() for p in tree_leaves(params)),
                "seconds": time.perf_counter() - t0,
                "page_tokens": engine.page_tokens})
    L, V = cfg.n_layers, cfg.vocab_size
    per_forward = (L, 0, 0, 0)    # the wgmma forward once per layer
    rng = np.random.default_rng(SEED + 1)

    def launched(fn):
        before = counts(fa)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        after = counts(fa)
        return (out, tuple(a - b for a, b in zip(after, before)),
                1e3 * (time.perf_counter() - t))

    def tokens_ok(toks, shape):
        check(toks.shape == shape, f"tokens shape {toks.shape} != {shape}")
        check(bool(((toks >= 0) & (toks < V)).all()), "token out of range")

    reset_counts(fa)
    # the main path starts here
    for n in PROMPT_LENS:
        prompt = rng.integers(0, V, (1, n)).astype(np.int32)
        bucket = engine.prefill_bucket(n)
        (toks, steps), got, _ms = launched(
            lambda: engine.generate(prompt, N_NEW, return_logits=True))
        check(got == per_forward, f"prompt {n}: launched {got}, want "
              f"{per_forward} {KERNELS}")
        tokens_ok(toks, (1, N_NEW))
        pre = []
        for _ in range(3):
            _out, got, ms = launched(lambda: engine.prefill(prompt))
            check(got == per_forward, f"prefill {n}: launched {got}")
            pre.append(ms)
        toks2, got, gen_ms = launched(lambda: engine.generate(prompt, N_NEW))
        check(got == per_forward and np.array_equal(toks2, toks),
              f"prompt {n}: greedy rerun differs or launched {got}")
        # teacher forcing: the full forward (kernel path) over prompt +
        # generated tokens against each step's logits (prefill, then the
        # plain-torch paged decode)
        full = np.concatenate([prompt, toks[:, :-1]], axis=1)
        ref, got, _ms = launched(lambda: model.apply(
            engine.params, torch.as_tensor(full, device=model.device)))
        check(got == per_forward, f"apply {n}: launched {got}")
        ref = ref[0, n - 1:].cpu().numpy()
        dec = np.concatenate(steps, axis=0)
        check(np.isfinite(dec).all() and np.isfinite(ref).all(),
              "non-finite logits")
        diff = float(np.abs(dec - ref).max())
        check(diff <= TOL_TEACHER_FORCED,
              f"prompt {n}: decode logits differ from apply by {diff}")
        prefill_ms = statistics.median(pre)
        emit(request={"prompt_len": n, "bucket": bucket,
                      "prefill_ms": prefill_ms, "generate_ms": gen_ms,
                      "decode_ms_per_token": (gen_ms - prefill_ms)
                      / (N_NEW - 1),
                      "teacher_forced_max_abs_diff": diff,
                      "argmax_agree": float(np.mean(
                          dec.argmax(-1) == ref.argmax(-1)))})

    batch = rng.integers(0, V, (4, 100)).astype(np.int32)
    toks, got, ms = launched(lambda: engine.generate(batch, N_NEW))
    check(got == per_forward, f"batch: launched {got}")
    tokens_ok(toks, (4, N_NEW))
    emit(batch={"batch": 4, "prompt_len": 100, "generate_ms": ms})

    topk = DecodeEngine(model, engine.params, max_len=1024, seed=7,
                        sampler=SamplerConfig("topk", top_k=40,
                                              temperature=0.8))
    prompt = rng.integers(0, V, (1, 300)).astype(np.int32)
    runs = []
    for _ in range(2):
        toks, got, ms = launched(lambda: topk.generate(prompt, N_NEW))
        check(got == per_forward, f"top-k: launched {got}")
        tokens_ok(toks, (1, N_NEW))
        runs.append(toks)
    check(np.array_equal(runs[0], runs[1]), "top-k runs differ")
    emit(topk={"top_k": 40, "temperature": 0.8, "seed": 7,
               "identical": True, "generate_ms": ms})
    return engine, model, counts(fa)


def _union_us(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_phase(torch, fa, engine):
    """One torch.profiler window over a single prefill at bucket 1024: the
    device's busy share of the window and the top device kernels by time.
    The Chrome trace goes to OUT_DIR/prefill_1024_trace.json."""
    prompt = np.random.default_rng(SEED + 2).integers(
        0, LARGE["vocab_size"], (1, PROFILE_PROMPT)).astype(np.int32)
    engine.prefill(prompt)
    torch.cuda.synchronize()
    reset_counts(fa)
    row = profile_window(torch, "prefill", lambda: engine.prefill(prompt),
                         "prefill_1024_trace.json")
    check(counts(fa) == (LARGE["n_layers"], 0, 0, 0),
          f"profiled prefill launched {counts(fa)}")
    emit(profile={"bucket": 1024, **row})


@contextlib.contextmanager
def plain_attention(fa):
    """The plain versions in place of the flash kernels, forward and
    backward, for ``fa.FlashAttention`` (which looks its functions up at
    call time): a reference run of the same model on the card."""
    kernels = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(q, k, v, causal=False, scale=None, out=None):
        o, lse = fa.flash_attention_reference(q, k, v, causal, scale)
        return (o if out is None else out.copy_(o)), lse

    def bwd(q, k, v, o, lse, do, causal=False, scale=None, out=None):
        grads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                 causal, scale)
        return grads if out is None else tuple(
            dst.copy_(x) for dst, x in zip(out, grads))

    fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = kernels


def train_phase(torch, fa):
    """Training at the bench's large config, batch 8 (bench.py's first
    rung): WARM_STEPS + TIMED_STEPS of ``make_train_step(adamw(3e-4))`` on
    one batch with targets rolled by −1, each launching the wgmma forward
    and the wgmma backward once per layer and the simple forward and the
    ``mma.sync`` backward never; then one gradient
    on the kernels held against one on the plain versions (loss and each
    leaf). Returns the launches of the steps and what the profile phase
    needs."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    from deeplearning4j_tpu_torch.tree import tree_leaves
    from deeplearning4j_tpu_torch.optim.adamw import adamw

    cfg = TransformerConfig(**LARGE)
    model = TransformerLM(cfg)
    params = from_jax_params(init_jax_layout(cfg, SEED), cfg)
    n_params = sum(a.numel() for a in tree_leaves(params))
    L, V, T = cfg.n_layers, cfg.vocab_size, cfg.max_len
    tokens = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, V, (TRAIN_BATCH, T)).astype(np.int32), device=model.device)
    targets = torch.roll(tokens, -1, dims=1)
    opt = adamw(LEARNING_RATE)
    state = opt.init(params)
    step = model.make_train_step(opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    reset_counts(fa)
    per_step = (L, 0, L, 0)
    for i in range(WARM_STEPS + TIMED_STEPS):    # the main path starts here
        before = counts(fa)
        t = time.perf_counter()
        params, state, loss = step(params, state, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        got = tuple(a - b for a, b in zip(counts(fa), before))
        check(got == per_step, f"train step {i}: launched {got}, want "
              f"{per_step} {KERNELS}")
        losses.append(loss)
    launches = counts(fa)                        # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    ms = statistics.median(step_ms[WARM_STEPS:])
    tokens_per_s = TRAIN_BATCH * T / (ms / 1e3)
    flops_per_token = train_flops_per_token(n_params, L, T, cfg.d_model)
    emit(train={"batch": TRAIN_BATCH, "seq_len": T, "params": n_params,
                "losses": losses, "step_ms": step_ms, "ms_per_step": ms,
                "tokens_per_s": tokens_per_s,
                "flops_per_token": flops_per_token,
                "mfu": tokens_per_s * flops_per_token
                / PEAK_FLOPS["bfloat16"],
                "peak_memory_bytes": peak_bytes,
                "launches": dict(zip(KERNELS, launches))})

    # one gradient on the kernels and one on the plain versions, same
    # weights and batch
    loss_k, grads_k = model.loss_and_grads(params, tokens, targets)
    leaves_k = tree_leaves(grads_k)
    check(all(bool(g.isfinite().all()) for g in leaves_k),
          "a gradient leaf is not finite")
    with plain_attention(fa):
        loss_p, grads_p = model.loss_and_grads(params, tokens, targets)
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(leaves_k, tree_leaves(grads_p))]
    d_loss = abs(float(loss_k) - float(loss_p))
    emit(train_vs_plain={"loss": float(loss_k), "plain_loss": float(loss_p),
                         "abs_diff_loss": d_loss,
                         "max_leaf_rel_l2": max(rel),
                         "median_leaf_rel_l2": statistics.median(rel),
                         "leaves": len(rel)})
    check(d_loss <= TOL_STEP_LOSS, f"loss on the kernels {float(loss_k)} vs "
          f"plain {float(loss_p)}")
    check(max(rel) <= TOL_STEP_LEAF, f"a gradient leaf's relative L2 error "
          f"{max(rel)} > {TOL_STEP_LEAF}")
    del grads_k, grads_p, leaves_k
    torch.cuda.empty_cache()
    return launches, ms, (step, params, state, tokens, targets)


def train_profile_phase(torch, fa, step_ms, step, params, state, tokens,
                        targets):
    """One torch.profiler window over one training step. The profiler's
    own host work stretches the window, so the device's busy time is also
    given over ``step_ms``, the median unprofiled step."""
    L = LARGE["n_layers"]
    reset_counts(fa)
    row = profile_window(torch, "train_step",
                         lambda: step(params, state, tokens, targets),
                         "train_step_trace.json", top=15)
    check(counts(fa) == (L, 0, L, 0),
          f"profiled step launched {counts(fa)}")
    if "device_busy_us" in row:
        row["busy_over_unprofiled_step"] = (row["device_busy_us"]
                                            / (1e3 * step_ms))
    emit(train_profile=row)


def _top(totals, n):
    return [{"name": name[:160], "us": us, "count": c}
            for name, (us, c) in sorted(totals.items(),
                                        key=lambda kv: -kv[1][0])[:n]]


def profile_window(torch, label, fn, trace_name, top=10):
    """One torch.profiler window over ``fn()`` (ending in a synchronise),
    its Chrome trace written to OUT_DIR/``trace_name``: the window's
    length, the device's busy time and share in it, and the device time
    by kernel and by the operator that launched each kernel (its
    "External id"; kernels launched outside any operator, as the port's
    ctypes kernels are, count under their own name)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    window = f"chip_smoke.{label}"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(window):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace = OUT_DIR / trace_name
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    windows = [e for e in events if e.get("ph") == "X"
               and e.get("name") == window
               and e.get("cat") == "user_annotation"]
    if not device or not windows:
        # only a rehearsal on the CPU, with TRACE_ON_DEVICE set to False,
        # gets here without failing
        check(not TRACE_ON_DEVICE,
              f"the profiler traced {len(device)} device events and "
              f"{len(windows)} {label} windows: busy share not measured")
        return {"wall_ms": wall_ms, "device_events": len(device),
                "busy_share": "not measured (the trace holds no device "
                "events or no window)"}
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in device], lo, hi)
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    by_name, by_op = {}, {}
    for e in device:
        if e.get("cat") != "kernel":
            continue
        for totals, key in ((by_name, e["name"]),
                            (by_op, ops.get(e.get("args", {}).get(
                                "External id"), e["name"]))):
            tot = totals.setdefault(key, [0.0, 0])
            tot[0] += float(e["dur"])
            tot[1] += 1
    copies = sum(n for name, (_us, n) in by_name.items()
                 if "copy" in name.lower())
    # every kernel of K1 and K2 (the D pass too), however small
    attention = {name: tot for name, tot in by_name.items() if re.search(
        r"flash|delta_kernel|dq_kernel|dkdv_kernel", name)}
    return {"wall_ms": wall_ms, "window_us": hi - lo,
            "device_busy_us": busy, "busy_share": busy / (hi - lo),
            "kernels": sum(n for _us, n in by_name.values()),
            "copy_kernels": copies, "trace": str(trace.relative_to(ROOT)),
            "top_kernels": _top(by_name, top), "top_ops": _top(by_op, top),
            "attention_kernels": _top(attention, len(attention))}


def kernel_entry(path, cases, launches):
    """The kernels-line entry of one forward kernel; ``launches`` maps each
    main path (serve, train) to its count."""
    rows = [r for r in cases.values() if r["path"] == path]
    main = cases[MAIN_CASE[path]]
    return {
        "name": f"flash_attention_fwd_{path}", "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[path]}",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:41",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": path == "wgmma",
        "max_abs_err": max(r["max_abs_err_o"] for r in rows),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_device_ms": main["library_device_ms"],
        "at": dict(zip(("layout", "b", "h", "t_q", "t_k", "d", "dtype",
                        "causal"), MAIN_CASE[path]))}


def bwd_kernel_entry(path, cases, launches):
    """The kernels-line entry of one K2 kernel ("bwd_wgmma" or "bwd"), its
    numbers at BWD_MAIN_CASE[path]. Its ``library_ms`` is SDPA's forward
    and backward, beside ``fwd_bwd_ms``: K1 + K2 on the same inputs (no
    one PyTorch call computes the backward alone; ``library_bwd_device_ms``
    is the difference of two device times)."""
    rows = [r for r in cases.values() if r["path"] == path]
    main = cases[BWD_MAIN_CASE[path]]
    return {
        "name": ("flash_attention_bwd_wgmma" if path == "bwd_wgmma"
                 else "flash_attention_bwd"), "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[path]}",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:153",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": path == "bwd_wgmma",
        "max_abs_err": max(e for r in rows
                           for e in r["max_abs_err"].values()),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_device_ms": main["library_device_ms"],
        "library_bwd_device_ms": main["library_bwd_device_ms"],
        "fwd_bwd_ms": main["fwd_bwd_ms"],
        "fwd_bwd_device_ms": main["fwd_bwd_device_ms"],
        "at": dict(zip(("layout", "b", "h", "t_q", "t_k", "d", "dtype",
                        "causal"), BWD_MAIN_CASE[path]))}


# one turn of --compare-bwd: the tree's own phases on the given cases
_TURN = """
import json, sys, torch, chip_smoke
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
fwd, bwd = json.loads(sys.argv[1])
chip_smoke.KERNEL_CASES = [tuple(c) for c in fwd]
chip_smoke.BWD_CASES = [tuple(c) for c in bwd]
chip_smoke.kernel_phase(torch, fa)
chip_smoke.bwd_phase(torch, fa)
"""


def compare_turns(other, this=ROOT):
    """Device ms of K1 at MAIN_CASE["wgmma"] and the training layer, and
    of K2 at every bf16 d 64/128 case of BWD_CASES, in the checkout at
    ``other`` and in ``this`` in turns (other, this, this, other), each
    turn a subprocess of that tree running its own ``kernel_phase`` and
    ``bwd_phase``. Returns {"fwd"|"bwd": {case: {"other": [ms, ms],
    "this": [ms, ms]}}}."""
    fwd = [MAIN_CASE["wgmma"], KERNEL_CASES[13]]
    bwd = [c for c in BWD_CASES if c[6] == "bfloat16" and c[5] in (64, 128)]
    arg = json.dumps([fwd, bwd])
    times = {"fwd": {}, "bwd": {}}
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        run = subprocess.run([sys.executable, "-c", _TURN, arg], cwd=root,
                             capture_output=True, text=True, timeout=900)
        check(run.returncode == 0, f"turn in {root} failed:\n"
              f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            for kind, key in (("fwd", "kernel_case"), ("bwd", "bwd_case")):
                if key in row:
                    r = row[key]
                    case = " ".join(str(r[k]) for k in (
                        "layout", "b", "h", "t_q", "t_k", "d", "causal"))
                    times[kind].setdefault(case, {}).setdefault(
                        label, []).append(r["device_ms"])
    return times


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-bwd", metavar="OTHER", type=Path,
                        help="time K1 and K2 here and in the checkout at "
                        "OTHER in turns, and nothing else")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port runs on the "
              "card", file=sys.stderr)
        return 2
    try:
        from deeplearning4j_tpu_torch.kernels import _build
        from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda)
    if args.compare_bwd is not None:
        emit(compare_turns=compare_turns(args.compare_bwd.resolve()))
        return 0

    t0 = time.perf_counter()
    compiled = _build.build_all()
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln
             or "C75" in ln]
    emit(build={"seconds": time.perf_counter() - t0, "compiled": compiled,
                "ptxas": ptxas})
    for name in ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma"):
        warned = serialized_wgmma(_build.build_logs.get(name, ""))
        check(not warned, f"{name}: ptxas serialized wgmma: {warned}")
    log = _build.build_logs.get("flash_attention_fwd_wgmma")
    if log is not None:     # compiled in this run, not an earlier library
        report = wgmma_ptxas(log)
        emit(wgmma_ptxas=report)
        check(sorted(report) == [64, 128] and all(
            r.get("registers") == WGMMA_ENTRY_REGISTERS
            and r.get("spill_bytes") == 0 for r in report.values()),
            f"wgmma kernel: want {WGMMA_ENTRY_REGISTERS} registers and no "
            f"spills at d 64 and 128, ptxas gave {report}")
    log = _build.build_logs.get("flash_attention_bwd_wgmma")
    if log is not None:
        report = bwd_wgmma_ptxas(log)
        emit(bwd_wgmma_ptxas=report)
        check(sorted(report) == ["d128 dkdv", "d128 dq", "d64 dkdv", "d64 dq"]
              and all("registers" in r and r.get("spill_bytes") == 0
                      for r in report.values()),
              f"wgmma backward: want no spills in its four kernels, ptxas "
              f"gave {report}")

    cases = kernel_phase(torch, fa)
    bwd_cases = bwd_phase(torch, fa)
    head_phase(torch)
    torch.cuda.empty_cache()
    engine, _model, serve = slice_phase(torch, fa)
    profile_phase(torch, fa, engine)
    del engine, _model
    torch.cuda.empty_cache()
    train, step_ms, for_profile = train_phase(torch, fa)
    train_profile_phase(torch, fa, step_ms, *for_profile)
    launches = {name: {"serve": serve[i], "train": train[i]}
                for i, name in enumerate(KERNELS)}
    emit(main_path_launches=launches)
    check(serve[0] > 0 and train[0] > 0,
          "a main path launched no flash_attention_fwd_wgmma")
    check(train[2] > 0, "training launched no flash_attention_bwd_wgmma")
    check(serve[1] == 0 and train[1] == 0,
          "a main path launched the simple kernel")
    check(serve[2] == serve[3] == train[3] == 0,
          "serving launched a backward, or training the mma.sync one")
    emit(kernels=[kernel_entry("wgmma", cases, launches["wgmma"]),
                  kernel_entry("simple", cases, launches["simple"]),
                  bwd_kernel_entry("bwd_wgmma", bwd_cases,
                                   launches["bwd_wgmma"]),
                  bwd_kernel_entry("bwd", bwd_cases, launches["bwd"])])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
