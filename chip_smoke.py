#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``kernels/csrc/`` with
``nvcc`` (one process per source, all at once), checks in ptxas's report
that the wgmma forward has 168 registers a thread at entry and no spills,
that the wgmma backward's and the wgmma K3's kernels and every
instantiation of K4a spill nothing, and that no wgmma source has its
products serialized (C7514/C7512), then:

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
   then K3 (chunked cross-entropy: the forward K3f and one chunk's dlogits
   K3b; the wgmma kernels for bf16, chunked_ce.cu's for f32, and both
   designs in turns at the training shape) and K7 (MoE dispatch K7d and
   combine K7c, each also in its gradient mode) against their plain
   versions at the training shapes and at ragged and small ones, timed the
   same two ways beside their bounds and the library calls they stand for
   (the unchunked head + CE and its backward; ``index_copy_`` /
   ``index_add_``); then K4 (K4a, the paged decode attention, over bf16,
   f32 and int8 pages and the dense cache's view, at the serving shapes and
   at edges: P 16, hd 16 and 128, a window past the span, a free slot, 64
   splits, W 16 at hd 128; K4w, the int8 quantize-and-scatter, bit-exact,
   for decode windows and a prefill insert) against their plain versions,
   timed the same two ways beside their bounds and, for K4a, the gather of
   the pages plus SDPA, which K4a must not lose to at 16 heads of 64; K4a
   must give the same bits on a second call and in every output of three
   CUDA-graph replays, and its split count is swept at the main decode
   step and the verify window (``decode_split_sweep``);
3. slice phase — serves generation from ``TransformerLM`` at the full
   width of the bench's large config (vocab 32768, 12 layers, 16 heads,
   d_model 1024, d_ff 4096, max_len 1024, bf16, fused QKV; random weights
   from a numpy seed through ``from_jax_params``) through ``DecodeEngine``
   in its default paged mode, checks the tokens and logits, and checks that
   every prefill and ``apply`` launched the wgmma kernel exactly once per
   layer and the simple kernel never, and every decode step K4a once per
   layer;
4. profile phase — one ``torch.profiler`` window over a single prefill at
   bucket 1024, and one over 4 decode steps after a 960-token prompt: the
   device's busy share and the top device kernels; then the serving modes
   at full width: int8 pages with plain decode, bf16 pages with speculative
   decoding (a 2-layer truncated draft with a dense cache, spec_k 4), and
   both: the int8 gate's record (the pool int8 if and only if it passed),
   the tokens against plain decode's up to its first near tie, the int8
   decode's logits against ``apply``, every kernel's launches per step and
   round, the accept ratio, prefill ms, ms per emitted token and the
   resident cache bytes, and an int8 pool through ``decode_window_paged``
   whatever the gate decided;
5. training phase — ``make_train_step(adamw(3e-4))`` at the same config on
   each of bench.py's rungs (batch, remat, ce_chunks) = (8, no, 0),
   (8, no, 8), (8, yes, 8), (4, yes, 8): 2 warm and 5 timed steps on one
   batch (ms per step, tokens/s, MFU by bench.py's count, peak memory), a
   falling finite loss, every kernel's launches a step as
   ``expected_per_step`` says (the wgmma forward twice per layer under
   remat), the first-step loss of the batch-8 rungs equal; one gradient on
   the kernels against one on their plain versions at (8, no, 8), and
   profiler windows over a step of each batch-8 rung;
6. MoE phase — the same config with a top-1 MoE FFN of 8 experts at
   capacity 1.25, (8, no, 8): the steps as above (K7 twice per layer a
   step), a profiled step, one gradient against K7's plain versions, and
   greedy generation from the trained model through ``DecodeEngine``.

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
# every kernel of the port, in the order all_counts() gives their launches:
# the four flash kernels, then K3f and K3b of chunked_ce.cu (f32 and bf16 at
# other d), K7d and K7c, then the wgmma K3f and K3b (bf16 at d % 64 == 0),
# then K4a (paged decode attention) and K4w (int8 quantize-and-scatter)
ALL_KERNELS = KERNELS + ("ce_fwd", "ce_dlogits", "moe_dispatch",
                         "moe_combine", "ce_fwd_wgmma", "ce_dlogits_wgmma",
                         "paged_attention", "kv_quant_write")
SOURCES.update(ce_fwd="chunked_ce.cu", ce_dlogits="chunked_ce.cu",
               moe_dispatch="moe_route.cu", moe_combine="moe_route.cu",
               ce_fwd_wgmma="chunked_ce_wgmma.cu",
               ce_dlogits_wgmma="chunked_ce_wgmma.cu",
               paged_attention="paged_attention.cu",
               kv_quant_write="paged_attention.cu")
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
# the same at the MoE phase with only K7 on its plain version: combine's f32
# sums (fused multiply-adds against rounded products) move a bf16 ulp here
# and there, and 12 layers carry it back to the first ones; set from the
# readings (|Δloss| 0, worst leaf 2.7e-3 at pos_emb; PERF.md)
TOL_MOE_STEP_LOSS = 5e-5
TOL_MOE_STEP_LEAF = 1e-2
# the tied LM head on the card (bf16 operands, f32 logits, bf16 dlogits in
# its backward) vs autograd through the f32 product, at the training layer:
# relative L2 error of the logits and of each gradient
TOL_HEAD = {"logits": 5e-6, "dx": 5e-3, "de": 5e-3}
# the training phase: bench.py's ladder for the large config, as (batch,
# remat, ce_chunks) (bench.py:323-324); the first rung is the one profiled
TRAIN_BATCH = 8
TRAIN_RUNGS = ((8, False, 0), (8, False, 8), (8, True, 8), (4, True, 8))
GRAD_RUNG = (8, False, 8)          # the rung of the kernels-vs-plain gradient
PROFILED_RUNGS = TRAIN_RUNGS[:3]   # a profiler window over one step of each
WARM_STEPS = 2
TIMED_STEPS = 5
LEARNING_RATE = 3e-4
# the MoE training phase: the large config with a top-1 MoE FFN of 8 experts
# (capacity factor 1.25), ce_chunks 8, batch 8, no remat
MOE_EXPERTS = 8
MOE_RUNG = (8, False, 8)
# K3 (chunked cross-entropy) cases: (rows N, vocab V, d, dtype, ce chunks);
# the first is the training layer (bench large config, batch 8). The bf16
# cases take the wgmma kernels, the f32 one chunked_ce.cu's
CE_CASES = [
    (8192, 32768, 1024, "bfloat16", 8),
    (4096, 32768, 1024, "bfloat16", 8),      # batch 4
    (1000, 5000, 1024, "bfloat16", 4),       # ragged rows and vocab
    (1, 384, 64, "bfloat16", 3),
    (1024, 4096, 256, "float32", 4),
]
# the case each K3 kernel's kernels-line numbers come from
CE_MAIN_CASE = {"ce_fwd_wgmma": CE_CASES[0], "ce_dlogits_wgmma": CE_CASES[0],
                "ce_fwd": CE_CASES[4], "ce_dlogits": CE_CASES[4]}
# K7 (MoE dispatch / combine) cases: (tokens G, experts E, slots C, top_k,
# d, dtype); the first is the training layer (G 8192, cf 1.25 top-1)
MOE_CASES = [
    (8192, 8, 1280, 1, 1024, "bfloat16"),
    (8192, 8, 2560, 2, 1024, "bfloat16"),    # top-2 at cf 1.25
    (1000, 8, 100, 2, 512, "bfloat16"),      # drops
    (8, 2, 4, 1, 64, "bfloat16"),
    (300, 4, 100, 2, 96, "float32"),
]
# tolerances (PERF.md gives the reasons): K3f's lse and loss against the
# plain version; K3b's dlogits off the target entries by relative L2, and at
# the target entries by max |Δ| over g/N; K7's gathers exact, combine within
# one bf16 ulp of its largest output (1e-6 in f32), d_gate 1e-2 (1e-5)
TOL_CE_LSE = 1e-4
TOL_CE_DLOG_L2 = {"bfloat16": 5e-3, "float32": 1e-5}
TOL_CE_DLOG_TARGET = {"bfloat16": 2 ** -7, "float32": 1e-5}
TOL_MOE_COMBINE = {"bfloat16": 2 ** -8, "float32": 1e-6}
TOL_MOE_DGATE = {"bfloat16": 1e-2, "float32": 1e-5}
# K4a (paged decode attention) cases: (slots B, window W, heads H, head dim
# hd, page tokens P, pages a slot n_lp, q's dtype, pool ("same" as q or
# "int8"), each slot's context (its window ends at context − 1), slots whose
# table row is all trash). The first is the main path's decode step (bench
# large config: 16 heads of 64, pages of 64 over a 1024 span); W 5 is the
# speculative verify window (spec_k 4); P = S = 1024 is the dense cache.
DECODE_CASES = [
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (1024,), ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (37,), ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (500,), ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (960,), ()),
    (1, 5, 16, 64, 64, 16, "bfloat16", "same", (960,), ()),
    (8, 1, 16, 64, 64, 16, "bfloat16", "same", (1024,) * 8, ()),
    (8, 5, 16, 64, 64, 16, "bfloat16", "same", (1024,) * 8, ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "int8", (1024,), ()),
    (1, 5, 16, 64, 64, 16, "bfloat16", "int8", (500,), ()),
    (8, 1, 16, 64, 64, 16, "bfloat16", "int8", (1024,) * 8, ()),
    (8, 5, 16, 64, 64, 16, "bfloat16", "int8", (37, 500, 960, 1024) * 2,
     ()),
    (1, 1, 16, 64, 1024, 1, "bfloat16", "same", (1024,), ()),   # dense
    (1, 5, 16, 64, 1024, 1, "bfloat16", "same", (960,), ()),
    (2, 3, 16, 64, 16, 64, "bfloat16", "int8", (700, 33), ()),  # P 16
    (1, 4, 8, 128, 64, 8, "bfloat16", "same", (512,), ()),      # hd 128
    (2, 2, 4, 16, 32, 4, "bfloat16", "int8", (128, 5), ()),     # hd 16
    (2, 5, 16, 64, 64, 16, "float32", "same", (300, 1024), ()),
    # a window whose tail runs past S, and a free slot (all trash)
    (3, 5, 16, 64, 64, 4, "bfloat16", "int8", (258, 40, 300), (1,)),
    # 64 splits through the last block's merge; W 16 at hd 128, where q
    # and o take the most registers (two warps' worth of queries)
    (1, 1, 1, 64, 64, 64, "bfloat16", "same", (4096,), ()),
    (1, 16, 8, 128, 64, 16, "bfloat16", "same", (1024,), ()),
]
DECODE_MAIN_CASE = {"paged_attention": DECODE_CASES[0],
                    "paged_attention_int8": DECODE_CASES[7],
                    "paged_attention_dense": DECODE_CASES[11]}
# K4a's split counts timed at the main decode step and the verify window
# (B 8, W 5), beside key_splits' own choice
SPLIT_SWEEP = {DECODE_CASES[0]: (4, 8, 9, 12, 16, 24, 32, 64),
               DECODE_CASES[6]: (1, 2, 3, 4, 6, 8, 16)}
# every instantiation of K4a's kernel in ptxas's report: compute dtype /
# pool type, queries a warp, elements a lane's chunk
K4A_INSTANTIATIONS = sorted(
    [f"bf16/same w{w} e8" for w in (1, 5, 8)]
    + [f"f32/same w{w} e4" for w in (1, 5, 8)]
    + [f"f32/same w{w} e8" for w in (1, 5)]
    + [f"{t}/int8 w1 e16" for t in ("bf16", "f32")]
    + [f"{t}/int8 w{w} e8" for t in ("bf16", "f32") for w in (1, 5, 8)])
# K4w cases: (slots B, window W, layers, page tokens P, rows' dtype); B = 1
# with W > 1 layer is a prefill insert (rows of a T-token bucket into whole
# pages, zero-padded), else a decode or verify window (one layer). Each has
# an all-zero row. The first is the main path's decode step.
QUANT_CASES = [
    (1, 1, 1, 64, "bfloat16"),
    (1, 5, 1, 64, "bfloat16"),
    (8, 5, 1, 64, "bfloat16"),
    (2, 5, 1, 16, "float32"),
    (1, 1024, 12, 64, "bfloat16"),      # the insert at bucket 1024
    (1, 32, 12, 64, "bfloat16"),        # bucket 32 into one padded page
]
# the serving modes at full width: int8 pages with plain decode, bf16 pages
# with speculative decoding (a 2-layer truncated draft with a dense cache,
# spec_k 4), and both
SPEC_K = 4
DRAFT_LAYERS = 2
# the first-step loss of a rung with ce_chunks (or remat) against the same
# batch and weights at (8, False, 0): f32 sums in another order
TOL_RUNG_LOSS = 5e-5
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


_SIDE = []


def _warm_on_side(fn, torch):
    """One call of ``fn`` on a side stream before a capture, as CUDA graphs
    ask. One side stream serves every call: cuBLAS keeps a 32 MiB workspace
    for each stream a product ran on, for the life of the process."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def device_ms(fn, torch, launches=20, repeats=7):
    """Device time per call of ``fn``: ``launches`` calls captured into one
    CUDA graph, the median over ``repeats`` replays timed with CUDA events.
    The host's work runs once, at capture, so it is not in the time."""
    _warm_on_side(fn, torch)
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


def graph_outputs(fn, torch, launches=20, replays=3):
    """Copies of the outputs of ``launches`` calls of ``fn`` captured in one
    CUDA graph, taken after each of ``replays`` replays."""
    _warm_on_side(fn, torch)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(launches)]
    got = []
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        got.extend(o.clone() for o in outs)
    del graph
    return got


def exactness(first, second, replayed):
    """A kernel's run-to-run fields: ``deterministic`` (a second eager call
    gave the first's bits) and ``replay_exact`` (so did every output of
    every CUDA-graph replay)."""
    return {"deterministic": bool(first.equal(second)),
            "replay_exact": bool(replayed)
            and all(bool(first.equal(r)) for r in replayed)}


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


def k4a_ptxas(log):
    """{"bf16/same w1 e8": {"registers": n, "spill_bytes": n}, ...} for
    each instantiation of K4a's ``paged_attend_kernel<DT, KQ, WM, E>``."""
    return _ptxas(
        log, r"paged_attend_kernelILi(\d)ELi(\d)ELi(\d+)ELi(\d+)EE",
        lambda m: (("bf16" if m.group(1) == "1" else "f32") + "/"
                   + ("int8" if m.group(2) == "1" else "same")
                   + f" w{m.group(3)} e{m.group(4)}"))


def spill_free(report, want):
    """True when ``report`` (from :func:`_ptxas`) lists exactly the
    entries ``want``, each with its registers and no spilled bytes."""
    return sorted(report) == sorted(want) and all(
        "registers" in r and r.get("spill_bytes") == 0
        for r in report.values())


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


def ce_wgmma_ptxas(log):
    """{"fwd"|"dlogits": {"registers": n, "spill_bytes": n}} for the two
    instantiations of the wgmma chunked cross-entropy kernel."""
    return _ptxas(log, r"ce_wgmma_kernelILb([01])E",
                  lambda m: "dlogits" if m.group(1) == "1" else "fwd")


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


def all_counts():
    """Launches of every kernel of the port, in the order of ALL_KERNELS."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    return counts(fa) + (ce.launches_fwd, ce.launches_dlogits,
                         mr.launches_dispatch, mr.launches_combine,
                         ce.launches_fwd_wgmma, ce.launches_dlogits_wgmma,
                         pa.launches_attend, pa.launches_quant_write)


def reset_all_counts():
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    reset_counts(fa)
    ce.launches_fwd = ce.launches_dlogits = 0
    ce.launches_fwd_wgmma = ce.launches_dlogits_wgmma = 0
    mr.launches_dispatch = mr.launches_combine = 0
    pa.launches_attend = pa.launches_quant_write = 0


def delta(before):
    """Each kernel's launches since ``before`` (an ``all_counts()``)."""
    return tuple(a - b for a, b in zip(all_counts(), before))


def ce_fwd_bound_ms(n, v, d, dtype):
    """K3f's least time: 2·N·V·d FLOPs of the logits over the peak of the
    type, against x and E read once, targets read and lse written once."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(2.0 * n * v * d, item * (n + v) * d + 8 * n + 4 * n + 4,
                  dtype)


def ce_dlogits_bound_ms(n, c, d, dtype):
    """One K3b launch's least time: 2·N·C·d FLOPs against x, the chunk of
    E, targets and lse read once and the (N, C) dlogits written once."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(2.0 * n * c * d,
                  item * (n + c) * d + 12 * n + item * n * c, dtype)


def moe_bound_ms(rows_read, rows_written, d, dtype, index_bytes):
    """A K7 launch's least time: the rows it must read and write, each
    once, and its index maps, over the memory rate (no arithmetic to
    speak of)."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(0.0, item * d * (rows_read + rows_written) + index_bytes,
                  dtype)


def dlogits_errors(got, ref, t_local, scale):
    """(relative L2 error off the targets, max |Δ| at the targets over
    ``scale``) of one chunk's dlogits; ``t_local`` holds each row's target
    column in the chunk, or −1. Held apart because the target entries
    (≈ −g/N) would hide a wrong softmax (≈ g/(N·V) each) in any norm over
    all entries."""
    import torch
    got, ref = got.float(), ref.float()
    on = torch.zeros_like(ref, dtype=torch.bool)
    rows = torch.nonzero(t_local >= 0)[:, 0]
    on[rows, t_local[rows]] = True
    off_ref = torch.where(on, 0.0, ref)
    off_err = torch.where(on, 0.0, got - ref)
    rel = (off_err.norm() / off_ref.norm().clamp_min(1e-30)).item()
    at = ((got - ref)[on].abs().max().item() / scale) if bool(on.any()) \
        else 0.0
    return rel, at


def ce_inputs(torch, case):
    """x (N, d), E (V, d) at the init's scale and targets for one of
    CE_CASES, the first three targets on vocab 0, the first chunk's edge
    and V − 1."""
    n, v, d, dtype, chunks = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(n * 7 + v + d)
    x = torch.randn((n, d), generator=g, device="cuda").to(dt)
    e = (0.02 * torch.randn((v, d), generator=g, device="cuda")).to(dt)
    t = torch.randint(0, v, (n,), generator=g, device="cuda")
    c = v // chunks
    t[: min(n, 3)] = torch.tensor([0, c, v - 1], device="cuda")[: min(n, 3)]
    return x, e, t


def ce_checked(torch, ce, case, x, e, t, lse_ref, cor, kernel=None):
    """Run K3f and the first chunk's K3b once through their wrappers (the
    kernel ``kernel`` names, or the one the wrappers choose), check that
    exactly that kernel launched and hold both against their plain
    versions. Returns (path, max |Δlse|, |Δloss|, max |Δdlogits|, relative
    L2 off the targets, max |Δ| at the targets over g/N)."""
    n, v, d, dtype, chunks = case
    path = kernel or ce.kernel_for("cuda", x.dtype, d, True)
    counters = {"wgmma": ("launches_fwd_wgmma", "launches_dlogits_wgmma"),
                "mma_sync": ("launches_fwd", "launches_dlogits")}
    reset_all_counts()
    lse, loss = ce.chunked_ce_fwd(x, e, t, chunks, kernel=kernel)
    torch.cuda.synchronize()
    want = [0] * len(ALL_KERNELS)
    want[ALL_KERNELS.index("ce_fwd" + ("_wgmma" if path == "wgmma"
                                       else ""))] = 1
    check(all_counts() == tuple(want), f"K3f {case} ({path}): launched "
          f"{all_counts()} {ALL_KERNELS}")
    err_lse = (lse - lse_ref).abs().max().item()
    err_loss = abs(loss.item() - (lse_ref - cor).mean().item())
    check(err_lse <= TOL_CE_LSE and err_loss <= TOL_CE_LSE,
          f"K3f {case} ({path}): max |dlse| {err_lse}, |dloss| {err_loss} > "
          f"{TOL_CE_LSE}")
    c = v // chunks
    gr = torch.ones((), device="cuda")
    dlog = ce.ce_dlogits(x, e[:c], t, lse_ref, 0, gr, n, kernel=kernel)
    ref = ce.ce_dlogits_reference(x, e[:c], t, lse_ref, 0, gr, n)
    torch.cuda.synchronize()
    check(getattr(ce, counters[path][1]) == 1, f"K3b {case} ({path}): did "
          f"not launch")
    local = torch.where(t < c, t, -1)
    rel, at = dlogits_errors(dlog, ref, local, 1.0 / n)
    check(rel <= TOL_CE_DLOG_L2[dtype] and at <= TOL_CE_DLOG_TARGET[dtype],
          f"K3b {case} ({path}): relative L2 off the targets {rel}, at the "
          f"targets {at} of g/N")
    err_dlog = (dlog.float() - ref.float()).abs().max().item()
    return path, err_lse, err_loss, err_dlog, rel, at


def ce_phase(torch):
    """K3f and K3b against their plain versions at each of CE_CASES (the
    wgmma kernels on the bf16 cases, chunked_ce.cu's on the f32 one),
    timed as the flash kernels are. K3f's library time is the unchunked
    path it replaces, two calls: the tied head's product into f32 logits
    (``_TiedHead``, or the f32 product) and logsumexp minus the gathered
    target logit; K3b's is that path's backward (the f32 dlogits, then the
    head's bf16 backward), as the difference of its forward + backward and
    its forward. K3b itself is timed per launch (one ce chunk) and as the
    whole chunked backward (every chunk's K3b and its two products). At
    the training shape chunked_ce.cu's kernels also run on the bf16
    operands, held to the plain versions too, and both designs' device
    times are taken in turns (mma.sync, wgmma, wgmma, mma.sync)."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.models.transformer import _TiedHead
    results = {}
    for case in CE_CASES:
        n, v, d, dtype, chunks = case
        dt = getattr(torch, dtype)
        x, e, t = ce_inputs(torch, case)
        c = v // chunks
        e0 = e[:c]
        gr = torch.ones((), device="cuda")
        lse_ref, cor = ce.chunked_ce_fwd_reference(x, e, t, chunks)
        path, err_lse, err_loss, err_dlog, rel, at = ce_checked(
            torch, ce, case, x, e, t, lse_ref, cor)

        def head_fwd(xs, es):
            if dt == torch.bfloat16:
                logits = _TiedHead.apply(xs, es)
            else:
                logits = xs @ es.T
            return (torch.logsumexp(logits, -1)
                    - logits.gather(-1, t[:, None])[:, 0]).mean()

        def library_fwd():
            xs, es = (a.detach().requires_grad_() for a in (x, e))
            head_fwd(xs, es)

        def library():
            xs, es = (a.detach().requires_grad_() for a in (x, e))
            torch.autograd.grad(head_fwd(xs, es), (xs, es))

        def fwd(kernel=None):
            ce.chunked_ce_fwd(x, e, t, chunks, kernel=kernel)

        def dlogits(kernel=None):
            ce.ce_dlogits(x, e0, t, lse_ref, 0, gr, n, kernel=kernel)

        def backward():
            ce.chunked_ce_bwd(x, e, t, lse_ref, gr, chunks)

        big = n * v >= 2 ** 26
        row = {"path": path, "n": n, "v": v, "d": d, "dtype": dtype,
               "ce_chunks": chunks,
               "max_abs_err_lse": err_lse, "abs_err_loss": err_loss,
               "max_abs_err_dlogits": err_dlog,
               "dlogits_rel_l2_off_target": rel,
               "dlogits_err_at_target_over_scale": at,
               "fwd_ms": time_ms(fwd, torch),
               "fwd_device_ms": device_ms(fwd, torch),
               "fwd_plain_ms": time_ms(
                   lambda: ce.chunked_ce_fwd_reference(x, e, t, chunks),
                   torch, iters=3, repeats=3),
               "dlogits_ms": time_ms(dlogits, torch),
               "dlogits_device_ms": device_ms(dlogits, torch),
               "dlogits_plain_ms": time_ms(
                   lambda: ce.ce_dlogits_reference(x, e0, t, lse_ref, 0, gr,
                                                   n), torch, iters=3,
                   repeats=3),
               "backward_ms": time_ms(backward, torch, iters=5, repeats=5),
               "backward_device_ms": device_ms(backward, torch, launches=5,
                                               repeats=5),
               "library": "_TiedHead (torch.mm out_dtype=f32) + "
                          "logsumexp - gather; its backward",
               "library_ms": time_ms(library_fwd, torch, iters=5,
                                     repeats=5),
               "library_device_ms": device_ms(library_fwd, torch,
                                              launches=5, repeats=5),
               "library_fwd_bwd_device_ms": device_ms(
                   library, torch, launches=2 if big else 5, repeats=5)}
        row["library_bwd_device_ms"] = (row["library_fwd_bwd_device_ms"]
                                        - row["library_device_ms"])
        row["library_bwd_ms"] = (time_ms(library, torch, iters=5, repeats=5)
                                 - row["library_ms"])
        row["fwd_bound_ms"], row["fwd_bound_by"] = ce_fwd_bound_ms(
            n, v, d, dtype)
        row["dlogits_bound_ms"], row["dlogits_bound_by"] = \
            ce_dlogits_bound_ms(n, c, d, dtype)
        row["fwd_device_vs_bound"] = row["fwd_device_ms"] / row[
            "fwd_bound_ms"]
        row["backward_device_vs_bound"] = row["backward_device_ms"] / (
            chunks * row["dlogits_bound_ms"])
        if case == CE_CASES[0]:
            # chunked_ce.cu's kernels on the same bf16 operands: held to
            # the plain versions, then both designs timed in turns
            _p, *errs = ce_checked(torch, ce, case, x, e, t, lse_ref, cor,
                                   kernel="mma_sync")
            row["mma_sync_errors"] = dict(zip(
                ("max_abs_err_lse", "abs_err_loss", "max_abs_err_dlogits",
                 "dlogits_rel_l2_off_target",
                 "dlogits_err_at_target_over_scale"), errs))
            turns = {"fwd": {"mma_sync": [], "wgmma": []},
                     "dlogits": {"mma_sync": [], "wgmma": []}}
            for kernel in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
                for what, fn in (("fwd", fwd), ("dlogits", dlogits)):
                    turns[what][kernel].append(device_ms(
                        lambda: fn(kernel), torch))
            row["turns_device_ms"] = turns
        emit(ce_case=row)
        results[case] = row
        torch.cuda.empty_cache()
    return results


def moe_route_inputs(torch, case):
    """Routing of random router probabilities for one of MOE_CASES, and
    x, out_e and dy rows: (gates, slot, src, x, out_e, dy)."""
    from deeplearning4j_tpu_torch.parallel import moe as tmoe
    G, E, C, K, d, dtype = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(G * 31 + E * 7 + C + d)
    probs = torch.softmax(torch.randn((G, E), generator=g, device="cuda"), -1)
    cfg = tmoe.MoEConfig(d_model=d, d_ff=d, num_experts=E, top_k=K)
    _c, gates, slot, src, _oh = tmoe.route(probs, cfg, C)
    x, dy = (torch.randn((G, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    out_e = torch.randn((E * C, d), generator=g, device="cuda").to(dt)
    return gates.to(dt).contiguous(), slot, src, x, out_e, dy


def moe_phase(torch):
    """K7d (dispatch, and with gates combine's backward) and K7c (combine,
    and with unit gates dispatch's backward) against their plain versions
    at each of MOE_CASES, timed as the flash kernels are. The library times
    are index_copy_ into zeroed buffers (dispatch) and index_add_ of the
    weighted rows (combine)."""
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    results = {}
    for case in MOE_CASES:
        G, E, C, K, d, dtype = case
        gates, slot, src, x, out_e, dy = moe_route_inputs(torch, case)
        mr.launches_dispatch = mr.launches_combine = 0
        ei = mr.moe_dispatch(x, src, K)
        y = mr.moe_combine(out_e, slot, gates)
        dx = mr.moe_combine(ei, slot)
        d_out, d_gates = mr.moe_dispatch_grad(dy, src, K, gates, out_e)
        torch.cuda.synchronize()
        check((mr.launches_dispatch, mr.launches_combine) == (2, 2),
              f"K7 {case}: launched {(mr.launches_dispatch, mr.launches_combine)}")
        check(torch.equal(ei, mr.dispatch_reference(x, src, K)),
              f"K7d {case}: dispatch differs from its plain version")
        ref_out, ref_gates = mr.dispatch_grad_reference(dy, src, K, gates,
                                                        out_e)
        check(torch.equal(d_out, ref_out),
              f"K7d {case}: combine's backward rows differ")
        errs = {}
        for name, got, ref, tol in (
                ("combine", y, mr.combine_reference(out_e, slot, gates),
                 TOL_MOE_COMBINE[dtype]),
                ("dispatch_grad", dx, mr.combine_reference(ei, slot),
                 TOL_MOE_COMBINE[dtype]),
                ("d_gate", d_gates, ref_gates, TOL_MOE_DGATE[dtype])):
            top = max(ref.float().abs().max().item(), 1e-30)
            errs[name] = (got.float() - ref.float()).abs().max().item()
            check(errs[name] <= tol * top, f"K7 {case} {name}: max |Δ| "
                  f"{errs[name]} > {tol} × {top}")
        kept_choice = slot >= 0
        n_kept = int(kept_choice.sum())
        kept_slot = src >= 0
        slot_idx = torch.nonzero(kept_slot)[:, 0]
        tok_idx = (src[kept_slot] // K).long()
        flat = torch.nonzero(kept_choice.reshape(-1))[:, 0]
        add_tok = flat // K
        add_slot = slot.reshape(-1)[flat].long()
        add_w = gates.reshape(-1)[flat].float()[:, None]

        def dispatch():
            mr.moe_dispatch(x, src, K)

        def combine():
            mr.moe_combine(out_e, slot, gates)

        def library_dispatch():
            torch.zeros_like(out_e).index_copy_(0, slot_idx,
                                                x.index_select(0, tok_idx))

        def library_combine():
            torch.zeros((G, d), device="cuda").index_add_(
                0, add_tok, out_e.index_select(0, add_slot).float() * add_w)

        row = {"g": G, "e": E, "c": C, "top_k": K, "d": d, "dtype": dtype,
               "kept_choices": n_kept, "max_abs_err": errs,
               "dispatch_ms": time_ms(dispatch, torch),
               "dispatch_device_ms": device_ms(dispatch, torch),
               "dispatch_plain_ms": time_ms(
                   lambda: mr.dispatch_reference(x, src, K), torch, iters=5,
                   repeats=5),
               "dispatch_library_ms": time_ms(library_dispatch, torch),
               "dispatch_library_device_ms": device_ms(library_dispatch,
                                                       torch),
               "combine_ms": time_ms(combine, torch),
               "combine_device_ms": device_ms(combine, torch),
               "combine_plain_ms": time_ms(
                   lambda: mr.combine_reference(out_e, slot, gates), torch,
                   iters=5, repeats=5),
               "combine_library_ms": time_ms(library_combine, torch),
               "combine_library_device_ms": device_ms(library_combine,
                                                      torch),
               "library": "zeros + index_copy_ of index_select (dispatch); "
                          "zeros + index_add_ of weighted index_select "
                          "(combine)"}
        row["dispatch_bound_ms"], row["dispatch_bound_by"] = moe_bound_ms(
            n_kept, E * C, d, dtype, 4 * E * C)
        row["combine_bound_ms"], row["combine_bound_by"] = moe_bound_ms(
            n_kept, G, d, dtype, G * K * (4 + (2 if dtype == "bfloat16"
                                               else 4)))
        emit(moe_case=row)
        results[case] = row
    return results


@contextlib.contextmanager
def plain_kernels(fa, moe_only=False):
    """The plain versions in place of every kernel of the port (flash
    attention forward and backward, K3f and K3b, K7d and K7c), or of K7's
    alone with ``moe_only``, each looked up at call time by its caller: a
    reference run of the same model on the card."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    saved = [(mr, "moe_dispatch", mr.moe_dispatch),
             (mr, "moe_combine", mr.moe_combine),
             (mr, "moe_dispatch_grad", mr.moe_dispatch_grad)]
    mr.moe_dispatch = mr.dispatch_reference
    mr.moe_combine = mr.combine_reference
    mr.moe_dispatch_grad = mr.dispatch_grad_reference
    if not moe_only:
        saved += [(ce, "chunked_ce_fwd", ce.chunked_ce_fwd),
                  (ce, "ce_dlogits", ce.ce_dlogits)]

        def ce_fwd(x2, emb, targets, n_chunks):
            lse, correct = ce.chunked_ce_fwd_reference(x2, emb, targets,
                                                       n_chunks)
            return lse, (lse - correct).mean()

        ce.chunked_ce_fwd, ce.ce_dlogits = ce_fwd, ce.ce_dlogits_reference
    try:
        with (contextlib.nullcontext() if moe_only
              else plain_attention(fa)):
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def leaf_paths(tree, prefix=""):
    """Names of a param tree's leaves in ``tree_leaves`` order (dict keys
    sorted, list items by index)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def expected_per_step(n_layers, remat, ce_chunks, moe=False):
    """Launches of each kernel (ALL_KERNELS' order) in one training step of
    the bf16 large config: the wgmma forward once per layer (twice under
    remat: the recompute), the wgmma backward once per layer, the wgmma
    K3f once and K3b once per ce chunk when ce_chunks (chunked_ce.cu's
    never: d 1024 is a multiple of 64), and for a MoE model K7d and K7c
    twice per layer (the forward's dispatch and combine, and each one's
    backward in the other kernel; three times under remat); K4a and K4w
    (decode only) never."""
    L = n_layers
    k7 = (3 if remat else 2) * L if moe else 0
    return ((2 if remat else 1) * L, 0, L, 0, 0, 0, k7, k7,
            1 if ce_chunks else 0, ce_chunks, 0, 0)


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
    # the wgmma forward once per layer of a prefill or apply, K4a once per
    # layer of each decode step (bf16 pages: K4w never), nothing else
    per_forward = (L,) + (0,) * 11
    per_generate = (L,) + (0,) * 9 + ((N_NEW - 1) * L, 0)
    rng = np.random.default_rng(SEED + 1)

    def launched(fn):
        before = all_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, delta(before), 1e3 * (time.perf_counter() - t)

    def tokens_ok(toks, shape):
        check(toks.shape == shape, f"tokens shape {toks.shape} != {shape}")
        check(bool(((toks >= 0) & (toks < V)).all()), "token out of range")

    reset_all_counts()
    # the main path starts here
    for n in PROMPT_LENS:
        prompt = rng.integers(0, V, (1, n)).astype(np.int32)
        bucket = engine.prefill_bucket(n)
        (toks, steps), got, _ms = launched(
            lambda: engine.generate(prompt, N_NEW, return_logits=True))
        check(got == per_generate, f"prompt {n}: launched {got}, want "
              f"{per_generate} {ALL_KERNELS}")
        tokens_ok(toks, (1, N_NEW))
        pre = []
        for _ in range(3):
            _out, got, ms = launched(lambda: engine.prefill(prompt))
            check(got == per_forward, f"prefill {n}: launched {got}")
            pre.append(ms)
        toks2, got, gen_ms = launched(lambda: engine.generate(prompt, N_NEW))
        check(got == per_generate and np.array_equal(toks2, toks),
              f"prompt {n}: greedy rerun differs or launched {got}")
        # teacher forcing: the full forward (kernel path) over prompt +
        # generated tokens against each step's logits (prefill, then the
        # paged decode through K4a)
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
    check(got == per_generate, f"batch: launched {got}")
    tokens_ok(toks, (4, N_NEW))
    emit(batch={"batch": 4, "prompt_len": 100, "generate_ms": ms})

    topk = DecodeEngine(model, engine.params, max_len=1024, seed=7,
                        sampler=SamplerConfig("topk", top_k=40,
                                              temperature=0.8))
    prompt = rng.integers(0, V, (1, 300)).astype(np.int32)
    runs = []
    for _ in range(2):
        toks, got, ms = launched(lambda: topk.generate(prompt, N_NEW))
        check(got == per_generate, f"top-k: launched {got}")
        tokens_ok(toks, (1, N_NEW))
        runs.append(toks)
    check(np.array_equal(runs[0], runs[1]), "top-k runs differ")
    emit(topk={"top_k": 40, "temperature": 0.8, "seed": 7,
               "identical": True, "generate_ms": ms})
    return engine, model, all_counts()


def k4_inputs(torch, case):
    """q as the (B, W, H, hd) view of a fused projection (strided, as the
    model hands it over), pools of B·n_lp pages + trash (int8 from
    quantized random rows with their scales, or q's dtype), each slot's
    pages a random permutation (the trash slots' rows all trash), and
    window positions ending at each slot's context − 1."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B * 131 + W * 17 + hd + P)
    n_pages = B * n_lp + 1
    proj = torch.randn((B, W, 3 * H * hd), generator=g, device="cuda")
    q = proj.to(dt)[..., :H * hd].view(B, W, H, hd)
    rows = torch.randn((2, n_pages, P, H, hd), generator=g, device="cuda")
    if pool == "int8":
        k8, ks = pa.quantize_kv_rows_reference(rows[0])
        v8, vs = pa.quantize_kv_rows_reference(rows[1])
        pools = (k8, v8, ks, vs)
    else:
        rows = rows.to(dt)
        pools = (rows[0].contiguous(), rows[1].contiguous(), None, None)
    perm = torch.randperm(B * n_lp, generator=g, device="cuda")
    tables = perm.view(B, n_lp).to(torch.int32)
    for b in trash:
        tables[b] = n_pages - 1
    pos = (torch.tensor(ctx, device="cuda")[:, None] - W
           + torch.arange(W, device="cuda")[None, :]).clamp_min(0)
    return q, pools, tables, pos.to(torch.int32)


def k4a_bound_ms(case, pos):
    """K4a's least time on this run's positions: the keys each slot needs
    (positions up to its largest query's, capped at S), k and v rows read
    once (with their f32 scales for int8 pages), their page-table entries,
    q and the positions read and o written once; against 4·hd operations
    per (query, needed key, head) in f32, the kernel's arithmetic (scalar
    FMAs: the f32 peak)."""
    B, W, H, hd, P, n_lp, dtype, pool, _ctx, _trash = case
    S = P * n_lp
    item = 2 if dtype == "bfloat16" else 4
    kv_item = 1 if pool == "int8" else item
    pos = pos.cpu().numpy().astype(np.int64)
    keys = np.minimum(pos.max(axis=1) + 1, S)
    nbytes = (int(keys.sum()) * (2 * H * hd * kv_item
                                 + (8 if pool == "int8" else 0))
              + 4 * int(np.ceil(keys / P).sum()) + 4 * B * W
              + 2 * B * W * H * hd * item)
    flops = 4.0 * H * hd * float(np.minimum(pos + 1, S).sum())
    return _bound(flops, nbytes, "float32")


def k4w_bound_ms(n_valid, n_rows, layers, c, dtype):
    """K4w's least time: the k and v rows read once, their int8 rows and
    f32 scales written once, and the (page, row) coordinates read (no
    arithmetic to speak of)."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(0.0, layers * (2 * n_valid * c * item + 2 * n_rows * c
                                 + 8 * n_rows) + 8 * n_rows, dtype)


def quant_inputs(torch, case):
    """Rows for one of QUANT_CASES (strided views of a fused projection for
    a window, a prefill's (L, 1, T, H, hd) k/v for an insert) with an
    all-zero row, their (page, row) coordinates, and zeroed int8 pools and
    scales of the large config's heads."""
    B, W, layers, P, dtype = case
    H, hd = LARGE["n_heads"], LARGE["d_model"] // LARGE["n_heads"]
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B * 7 + W + layers + P)
    if layers == 1:
        proj = torch.randn((B, W, 3 * H * hd), generator=g, device="cuda")
        proj[0, W - 1] = 0.0
        proj = proj.to(dt)
        k = proj[..., H * hd:2 * H * hd].view(B, W, H, hd)
        v = proj[..., 2 * H * hd:].view(B, W, H, hd)
        n_pages = -(-B * W // P) + 2
        flat = torch.randperm((n_pages - 1) * P, generator=g,
                              device="cuda")[:B * W].view(B, W)
        phys, off = (flat // P).to(torch.int32), (flat % P).to(torch.int32)
        phys[-1, -1], off[-1, -1] = n_pages - 1, 0          # the trash
        lead = ()
    else:
        kv = torch.randn((2, layers, 1, W, H, hd), generator=g,
                         device="cuda")
        kv[:, :, :, 0] = 0.0
        kv = kv.to(dt)
        k, v = kv[0], kv[1]
        npb = -(-W // P)
        n_pages = npb + 1
        ids = torch.randperm(npb, generator=g, device="cuda")
        t = torch.arange(npb * P, device="cuda")
        phys, off = ids[t // P][None].to(torch.int32), (t % P)[None].to(
            torch.int32)
        lead = (layers,)

    def pools():
        return [torch.zeros((*lead, n_pages, P, H, hd), dtype=torch.int8,
                            device="cuda") for _ in range(2)] + [
            torch.zeros((*lead, n_pages, P), device="cuda")
            for _ in range(2)]

    return k, v, phys, off, pools


def decode_kernel_phase(torch):
    """K4a against its plain version (the gather of each slot's pages and
    the reference attention) at each of DECODE_CASES, and K4w against its
    plain version (bit-exact) at each of QUANT_CASES, timed as the other
    kernels are: ``device_ms`` from CUDA-graph replays, ``ms`` with the
    host, the plain version, and for K4a the library call, the gather
    (dequantized for int8 pages) plus SDPA with a boolean mask."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    results = {}
    for case in DECODE_CASES:
        B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
        q, (k, v, ks, vs), tables, pos = k4_inputs(torch, case)
        pa.launches_attend = 0
        o = pa.paged_attention(q, k, v, tables, pos, ks, vs)
        torch.cuda.synchronize()
        check(pa.launches_attend == 1, f"K4a {case}: launched "
              f"{pa.launches_attend}")
        ref = pa.paged_attention_reference(q, k, v, tables, pos, ks, vs)
        err = (o.float() - ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= TOL_O[dtype],
              f"paged_attention {case}: max |do| {err} > {TOL_O[dtype]}")
        S = P * n_lp
        mask = (torch.arange(S, device="cuda")[None, None, None, :]
                <= pos.long()[:, None, :, None])

        def kernel():
            return pa.paged_attention(q, k, v, tables, pos, ks, vs)

        exact = exactness(o, kernel(), graph_outputs(kernel, torch))
        check(exact["deterministic"] and exact["replay_exact"],
              f"paged_attention {case}: not the same bits run to run "
              f"{exact}")

        def library():
            kk = pa.gather_pages(k, ks, tables, q.dtype).transpose(1, 2)
            vv = pa.gather_pages(v, vs, tables, q.dtype).transpose(1, 2)
            F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                           attn_mask=mask)

        bound_ms, bound_by = k4a_bound_ms(case, pos)
        row = {"b": B, "w": W, "h": H, "hd": hd, "page_tokens": P,
               "pages_a_slot": n_lp, "dtype": dtype, "pool": pool,
               "contexts": list(ctx), "trash_slots": list(trash),
               "splits": pa.attend_splits(q, k, v, tables)[0],
               "max_abs_err": err,
               "ms": time_ms(kernel, torch),
               "device_ms": device_ms(kernel, torch),
               "plain_ms": time_ms(lambda: pa.paged_attention_reference(
                   q, k, v, tables, pos, ks, vs), torch, iters=5, repeats=5),
               "library_ms": time_ms(library, torch),
               "library_device_ms": device_ms(library, torch),
               "bound_ms": bound_ms, "bound_by": bound_by, **exact}
        row["device_vs_bound"] = row["device_ms"] / bound_ms
        row["device_vs_library"] = (row["device_ms"]
                                    / row["library_device_ms"])
        emit(decode_case=row)
        results[case] = row
    for case, candidates in SPLIT_SWEEP.items():
        emit(decode_split_sweep=split_sweep(torch, case, candidates))
    slower = {str(c): r["device_vs_library"] for c, r in results.items()
              if c[2:4] == (16, 64) and r["device_vs_library"] > 1.0}
    check(not slower, f"K4a slower than the gather + SDPA at H 16, hd 64: "
          f"{slower}")
    for case in QUANT_CASES:
        B, W, layers, P, dtype = case
        k, v, phys, off, pools = quant_inputs(torch, case)
        got, want = pools(), pools()
        pa.launches_quant_write = 0
        pa.kv_quant_write(k, v, phys, off, *got)
        pa.kv_quant_write_reference(k, v, phys, off, *want)
        torch.cuda.synchronize()
        check(pa.launches_quant_write == 1, f"K4w {case}: launched "
              f"{pa.launches_quant_write}")
        for name, a, b in zip(("k", "v", "k_scale", "v_scale"), got, want):
            check(torch.equal(a, b), f"kv_quant_write {case}: {name} "
                  f"differs from its plain version")
        zero_scale = got[2][..., int(phys[0, W - 1]), int(off[0, W - 1])] \
            if layers == 1 else got[2][:, int(phys[0, 0]), int(off[0, 0])]
        check(bool((zero_scale == 1.0).all()), f"kv_quant_write {case}: "
              f"the all-zero row's scale is not 1")
        n_rows = phys.numel()
        n_valid = B * W
        C = LARGE["d_model"]

        def kernel():
            pa.kv_quant_write(k, v, phys, off, *got)

        bound_ms, bound_by = k4w_bound_ms(n_valid, n_rows, layers, C, dtype)
        row = {"b": B, "w": W, "layers": layers, "page_tokens": P,
               "dtype": dtype, "rows": n_rows, "max_abs_err": 0.0,
               "ms": time_ms(kernel, torch),
               "device_ms": device_ms(kernel, torch),
               "plain_ms": time_ms(lambda: pa.kv_quant_write_reference(
                   k, v, phys, off, *want), torch, iters=5, repeats=5),
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by}
        row["device_vs_bound"] = row["device_ms"] / bound_ms
        emit(quant_write_case=row)
        results[("quant",) + case] = row
    return results


def split_sweep(torch, case, candidates):
    """K4a's device time at each split count of ``candidates`` and at
    key_splits' own, on one of DECODE_CASES, each held to the plain
    version (:func:`split_sweep_row` gives the line)."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, _trash = case
    q, (k, v, ks, vs), tables, pos = k4_inputs(torch, case)
    ref = pa.paged_attention_reference(q, k, v, tables, pos, ks, vs)
    rule = pa.attend_splits(q, k, v, tables)[0]
    points = []
    for asked in sorted(set(candidates) | {rule}):
        splits, per = pa.attend_splits(q, k, v, tables, asked)

        def kernel():
            return pa.paged_attention(q, k, v, tables, pos, ks, vs,
                                      splits=asked)

        err = (kernel().float() - ref.float()).abs().max().item()
        check(err <= TOL_O[dtype], f"paged_attention {case} at {asked} "
              f"splits: max |do| {err} > {TOL_O[dtype]}")
        points.append({"splits": splits, "keys_per_split": per,
                       "blocks": splits * H * B, "max_abs_err": err,
                       "device_ms": device_ms(kernel, torch)})
    return split_sweep_row(case, rule, points)


def split_sweep_row(case, rule, points):
    """The ``decode_split_sweep`` line of one case: its shape, key_splits'
    choice (``rule_splits``), the fastest point and the rule's time over
    it, and every point (splits, keys a split, blocks, max |do|, device
    ms)."""
    B, W, H, hd, P, n_lp, dtype, pool, ctx, _trash = case
    best = min(points, key=lambda r: r["device_ms"])
    at_rule = [r["device_ms"] for r in points if r["splits"] == rule]
    return {"b": B, "w": W, "h": H, "hd": hd, "page_tokens": P,
            "pages_a_slot": n_lp, "dtype": dtype, "pool": pool,
            "contexts": list(ctx), "rule_splits": rule,
            "best_splits": best["splits"],
            "rule_vs_best": (at_rule[0] / best["device_ms"] if at_rule
                             else None),
            "points": points}


def near_tie_step(steps):
    """The first step whose plain-decode logits (1, V) have a top-2 gap of
    at most TOL_TEACHER_FORCED, or None: another matmul shape may round
    such a step's argmax either way under bf16."""
    for i, row in enumerate(steps):
        top = np.sort(np.asarray(row, np.float64)[0])[-2:]
        if top[1] - top[0] <= TOL_TEACHER_FORCED:
            return i
    return None


def serve_phase(torch, model, engine):
    """The three serving modes at full width against the default engine
    (bf16 pages, plain decode): (a) int8 pages with plain decode, (b) bf16
    pages with speculative decoding by a DRAFT_LAYERS-layer truncation of
    the target (its embeddings shared) with a dense cache, spec_k SPEC_K,
    (c) both. Greedy, PROMPT_LENS, N_NEW tokens. Checks the gate's record
    (the pool is int8 if and only if it passed), the tokens against plain
    decode's up to its first near-tie step, (a)'s teacher-forced logits
    against ``apply``, and every kernel's launches; times prefill and ms per
    emitted token; and runs an int8 pool through ``decode_window_paged``
    whatever the gate decides. Returns each kernel's launches in the
    phase."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    cfg = model.config
    L, V, P = cfg.n_layers, cfg.vocab_size, engine.page_tokens
    params = engine.params
    dmodel = TransformerLM(TransformerConfig(**dict(LARGE,
                                                    n_layers=DRAFT_LAYERS)))
    dparams = {"tok_emb": params["tok_emb"], "pos_emb": params["pos_emb"],
               "ln_f": params["ln_f"],
               "blocks": params["blocks"][:DRAFT_LAYERS]}
    rng = np.random.default_rng(SEED + 6)
    prompts = {n: rng.integers(0, V, (1, n)).astype(np.int32)
               for n in PROMPT_LENS}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def prefill_ms(eng, prompt):
        return statistics.median(timed(lambda: eng.prefill(prompt))[1]
                                 for _ in range(3))

    reset_all_counts()                   # the main path starts here
    draft = DecodeEngine(dmodel, dparams, max_len=cfg.max_len, page_tokens=0)
    base = {}
    for n, prompt in prompts.items():
        (toks, steps) = engine.generate(prompt, N_NEW, return_logits=True)
        _t, ms = timed(lambda: engine.generate(prompt, N_NEW))
        pre = prefill_ms(engine, prompt)
        base[n] = {"tokens": toks, "near_tie": near_tie_step(steps),
                   "prefill_ms": pre, "generate_ms": ms,
                   "ms_per_token": (ms - pre) / (N_NEW - 1)}
        emit(serve_base={"prompt_len": n, "pool": "bfloat16",
                         "near_tie_step": base[n]["near_tie"],
                         **{k: base[n][k] for k in ("prefill_ms",
                                                    "generate_ms",
                                                    "ms_per_token")}})
    modes = {"int8": dict(kv_quant=True),
             "spec": dict(draft=draft, spec_k=SPEC_K),
             "int8_spec": dict(kv_quant=True, draft=draft, spec_k=SPEC_K)}
    rows = {}
    for mode, kw in modes.items():
        eng = DecodeEngine(model, params, max_len=cfg.max_len, **kw)
        state = eng.new_state(1)
        gate = eng.quant_gate
        int8 = state.arrays["k"].dtype == torch.int8
        if "kv_quant" in kw:
            check(gate is not None and gate["checked"]
                  and int8 == bool(gate["passed"]) == eng.kv_quant,
                  f"{mode}: pool int8 {int8} but gate {gate}")
        else:
            check(gate is None and not int8, f"{mode}: gate {gate}")
        emit(quant_gate={"mode": mode, "record": gate, "int8_pool": int8})
        eng.warm(1)
        spec = eng.spec
        check(spec == ("draft" in kw), f"{mode}: spec {spec}")
        per = []
        for n, prompt in prompts.items():
            before, rounds0 = all_counts(), eng.spec_stats["rounds"]
            stats0 = dict(eng.spec_stats)
            toks, gen_ms = timed(lambda: eng.generate(prompt, N_NEW))
            got = delta(before)
            rounds = eng.spec_stats["rounds"] - rounds0
            steps = rounds if spec else N_NEW - 1
            k4a = steps * (L + (SPEC_K * DRAFT_LAYERS if spec else 0))
            k4w = (1 + steps * L) if int8 else 0
            want = ((L + (DRAFT_LAYERS if spec else 0),) + (0,) * 9
                    + (k4a, k4w))
            check(got == want, f"{mode} prompt {n}: launched {got}, want "
                  f"{want} {ALL_KERNELS}")
            check(toks.shape == (1, N_NEW) and bool(((toks >= 0)
                                                     & (toks < V)).all()),
                  f"{mode} prompt {n}: tokens {toks.shape}")
            tie = base[n]["near_tie"]
            upto = N_NEW if tie is None else tie
            check(np.array_equal(toks[:, :upto], base[n]["tokens"][:, :upto]),
                  f"{mode} prompt {n}: tokens differ from plain decode "
                  f"before step {upto} (its first near tie: {tie})")
            pre = prefill_ms(eng, prompt)
            dpre = prefill_ms(draft, prompt) if spec else 0.0
            row = {"mode": mode, "prompt_len": n, "int8_pool": int8,
                   "prefill_ms": pre, "draft_prefill_ms": dpre,
                   "generate_ms": gen_ms,
                   "ms_per_token": (gen_ms - pre - dpre) / (N_NEW - 1),
                   "plain_bf16_ms_per_token": base[n]["ms_per_token"],
                   "tokens_equal_plain": bool(np.array_equal(
                       toks, base[n]["tokens"])),
                   "plain_near_tie_step": tie,
                   "launches": dict(zip(ALL_KERNELS, got))}
            if spec:
                acc = eng.spec_stats["accepted"] - stats0["accepted"]
                prop = eng.spec_stats["proposed"] - stats0["proposed"]
                row.update(rounds=rounds, accept_ratio=acc / prop,
                           tokens_per_round=(N_NEW - 1) / rounds)
            else:
                (_t, steps_l) = eng.generate(prompt, N_NEW,
                                             return_logits=True)
                full = np.concatenate([prompt, toks[:, :-1]], axis=1)
                ref = model.apply(params, torch.as_tensor(
                    full, device=model.device))[0, n - 1:].cpu().numpy()
                dec = np.concatenate(steps_l, axis=0)
                diff = float(np.abs(dec - ref).max())
                check(np.isfinite(dec).all() and diff <= TOL_TEACHER_FORCED,
                      f"{mode} prompt {n}: decode logits differ from apply "
                      f"by {diff}")
                row["teacher_forced_max_abs_diff"] = diff
            emit(serve_mode=row)
            per.append(row)
        if spec:
            emit(spec_accept={"mode": mode,
                              "accept_ratio": eng.spec_accept_ratio(),
                              "stats": eng.spec_stats})
        rows[mode] = per
        _f, _l, kv, _t = eng.prefill(prompts[PROMPT_LENS[0]])
        st = eng.insert_slot(eng.new_state(1), kv, 0)
        bst = engine.insert_slot(engine.new_state(1), kv, 0)
        emit(resident_cache={"mode": mode, "prompt_len": PROMPT_LENS[0],
                             "bytes": eng.resident_cache_bytes(st),
                             "bf16_bytes": engine.resident_cache_bytes(bst),
                             "ratio": eng.resident_cache_bytes(st)
                             / engine.resident_cache_bytes(bst),
                             "page_bytes": eng.page_bytes()})
        del eng, state, st, bst
    # an int8 pool through decode_window_paged at full width, whatever the
    # gate decided: the prompt's rows written by K4w, a W = SPEC_K + 1
    # window, against the same window over bf16 pages
    n = PROMPT_LENS[0]
    _f, _l, kv, t = engine.prefill(prompts[n])
    npb = -(-kv["k"].shape[2] // P)
    n_lp = engine.pages_per_slot
    pools = {"int8": model.init_paged_cache(n_lp + 1, P, quant=True),
             "bf16": model.init_paged_cache(n_lp + 1, P)}
    tables = torch.full((1, n_lp), n_lp, dtype=torch.int32,
                        device=model.device)
    tables[0, :npb] = torch.arange(npb, device=model.device)
    pages = list(range(npb))
    for pool in pools.values():
        engine._write_pages(pool, kv, pages)
    win = torch.as_tensor(prompts[n][:, :SPEC_K + 1], device=model.device)
    pos = torch.tensor([t], device=model.device)
    before = all_counts()
    lq, _ = model.decode_window_paged(params, pools["int8"], tables, win,
                                      pos, P)
    torch.cuda.synchronize()
    got = delta(before)
    lb, _ = model.decode_window_paged(params, pools["bf16"], tables, win,
                                      pos, P)
    finite = bool(torch.isfinite(lq).all())
    check(got[10:] == (L, L) and finite,
          f"int8 window: launched {got}, finite logits {finite}")
    emit(int8_window={"prompt_len": n, "w": SPEC_K + 1,
                      "max_abs_logit_diff_vs_bf16_pages":
                      (lq - lb).abs().max().item(), "launches": got[10:]})
    launches = all_counts()              # ... and ends here
    del pools, kv, lq, lb, draft, dmodel
    torch.cuda.empty_cache()
    return launches


def decode_profile_phase(torch, engine):
    """One torch.profiler window over 4 decode steps of one slot after a
    960-token prompt: the device's busy share and the device time by
    kernel, K4a's among them."""
    prompt = np.random.default_rng(SEED + 7).integers(
        0, LARGE["vocab_size"], (1, PROFILE_PROMPT)).astype(np.int32)
    first, _l, kv, t = engine.prefill(prompt)
    state = engine.insert_slot(engine.new_state(1), kv, 0)
    toks, pos = first, np.full((1,), t, np.int32)
    toks, _l, state = engine.decode(state, toks, pos, 1)     # warm
    torch.cuda.synchronize()

    def steps():
        nonlocal toks, pos
        for i in range(4):
            pos = pos + 1
            toks, _lg, _st = engine.decode(state, toks, pos, 2 + i)

    reset_all_counts()
    row = profile_window(torch, "decode", steps, "decode_960_trace.json",
                         top=12)
    L = LARGE["n_layers"]
    check(all_counts() == (0,) * 10 + (4 * L, 0),
          f"profiled decode launched {all_counts()}")
    traced = sum(k["count"] for k in row.get("decode_kernels", ())
                 if "paged_attend_kernel" in k["name"])
    check(traced == 4 * L or not TRACE_ON_DEVICE,
          f"profiled decode traced {traced} K4a kernels, not one a layer "
          f"a step ({4 * L})")
    emit(decode_profile={"prompt_len": PROFILE_PROMPT, "steps": 4,
                         "kernels_per_step": row.get("kernels", 0) / 4,
                         **row})


def decode_kernel_entry(kind, cases, launches):
    """The kernels-line entry of K4a ("paged_attention", its numbers at the
    main path's decode step, bf16 pages; its int8 and dense-view cases
    beside them) or K4w ("kv_quant_write", at the decode step's rows; no
    single library call computes it)."""
    k4a = kind == "paged_attention"
    main = cases[DECODE_MAIN_CASE[kind] if k4a
                 else ("quant",) + QUANT_CASES[0]]
    rows = [r for c, r in cases.items() if (c[0] != "quant") == k4a]
    entry = {
        "name": kind, "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}",
        "replaces": "deeplearning4j_tpu/models/transformer.py:"
                    + ("827" if k4a else "107"),
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_device_ms": main.get("library_device_ms")}
    if k4a:
        entry["library"] = "gather of the slot's pages + SDPA (bool mask)"
        entry["at"] = dict(zip(("b", "w", "h", "hd", "page_tokens",
                                "pages_a_slot", "dtype", "pool", "contexts",
                                "trash_slots"), DECODE_MAIN_CASE[kind]))
        for other in ("paged_attention_int8", "paged_attention_dense"):
            r = cases[DECODE_MAIN_CASE[other]]
            entry[other.split("_")[-1]] = {
                k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "library_ms", "library_device_ms")}
    else:
        entry["at"] = dict(zip(("b", "w", "layers", "page_tokens", "dtype"),
                               QUANT_CASES[0]))
    return entry


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


def _train_model(torch, rung, tree_cache, moe=False):
    """(model, fresh params on the card, n_params, tokens, targets) for one
    rung (batch, remat, ce_chunks) of the large config: the weights of
    ``init_jax_layout(cfg, SEED)`` (drawn once per layout and kept in
    ``tree_cache``), tokens from a numpy seed, targets rolled by −1."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    from deeplearning4j_tpu_torch.parallel.moe import MoEConfig
    from deeplearning4j_tpu_torch.tree import tree_leaves
    batch, remat, chunks = rung
    cfg = TransformerConfig(**LARGE, remat=remat, ce_chunks=chunks,
                            moe=MoEConfig(num_experts=MOE_EXPERTS)
                            if moe else None)
    model = TransformerLM(cfg)
    if moe not in tree_cache:
        tree_cache[moe] = init_jax_layout(cfg, SEED)
    params = from_jax_params(tree_cache[moe], cfg)
    n_params = sum(a.numel() for a in tree_leaves(params))
    tokens = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len)).astype(np.int32)[
        :batch], device=model.device)
    return model, params, n_params, tokens, torch.roll(tokens, -1, dims=1)


def active_params(n_params, moe):
    """Params a token's forward touches: all of them for the dense FFN;
    for the MoE FFN, top-1 of MOE_EXPERTS experts' W1, b1, W2, b2."""
    if not moe:
        return n_params
    d, f, L = LARGE["d_model"], LARGE["d_ff"], LARGE["n_layers"]
    per_expert = 2 * d * f + f + d
    return n_params - L * (MOE_EXPERTS - 1) * per_expert


def train_rung(torch, fa, rung, tree_cache, moe=False):
    """WARM_STEPS + TIMED_STEPS of ``make_train_step(adamw(3e-4))`` at one
    rung (batch, remat, ce_chunks) of the large config on one batch, each
    step launching exactly ``expected_per_step`` of every kernel. Returns
    (row, the launches of the steps, what a profile window needs)."""
    from deeplearning4j_tpu_torch.optim.adamw import adamw
    batch, remat, chunks = rung
    torch.cuda.empty_cache()
    allocated_at_start = torch.cuda.memory_allocated()
    model, params, n_params, tokens, targets = _train_model(
        torch, rung, tree_cache, moe)
    L, T = model.config.n_layers, model.config.max_len
    opt = adamw(LEARNING_RATE)
    state = opt.init(params)
    step = model.make_train_step(opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    losses, step_ms = [], []
    per_step = expected_per_step(L, remat, chunks, moe)
    reset_all_counts()
    for i in range(WARM_STEPS + TIMED_STEPS):    # the main path starts here
        before = all_counts()
        t = time.perf_counter()
        params, state, loss = step(params, state, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        got = tuple(a - b for a, b in zip(all_counts(), before))
        check(got == per_step, f"rung {rung}{' MoE' if moe else ''} step "
              f"{i}: launched {got}, want {per_step} {ALL_KERNELS}")
        losses.append(loss)
    launches = all_counts()                      # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"rung {rung}: loss did not fall: "
          f"{losses}")
    ms = statistics.median(step_ms[WARM_STEPS:])
    tokens_per_s = batch * T / (ms / 1e3)
    flops_per_token = train_flops_per_token(active_params(n_params, moe), L,
                                            T, model.config.d_model)
    row = {"batch": batch, "remat": remat, "ce_chunks": chunks,
           "moe": moe, "seq_len": T, "params": n_params,
           "active_params": active_params(n_params, moe),
           "losses": losses, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": tokens_per_s, "flops_per_token": flops_per_token,
           "mfu": tokens_per_s * flops_per_token / PEAK_FLOPS["bfloat16"],
           "peak_memory_bytes": peak_bytes,
           # what earlier phases left allocated, and that plus the params
           # and AdamW's moments
           "allocated_at_start_bytes": allocated_at_start,
           "allocated_before_steps_bytes": allocated_before,
           "launches_per_step": dict(zip(ALL_KERNELS, per_step)),
           "launches": dict(zip(ALL_KERNELS, launches))}
    emit(train=row)
    return row, launches, (model, step, params, state, tokens, targets)


def grad_vs_plain(torch, fa, label, model, params, tokens, targets,
                  tol_loss, tol_leaf, moe_only=False):
    """One gradient on the kernels and one on their plain versions (K7's
    alone with ``moe_only``), same weights and batch: |Δloss| and each
    leaf's relative L2 error, the three worst leaves named."""
    from deeplearning4j_tpu_torch.tree import tree_leaves
    loss_k, grads_k = model.loss_and_grads(params, tokens, targets)
    leaves_k = tree_leaves(grads_k)
    check(all(bool(g.isfinite().all()) for g in leaves_k),
          f"{label}: a gradient leaf is not finite")
    with plain_kernels(fa, moe_only):
        loss_p, grads_p = model.loss_and_grads(params, tokens, targets)
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(leaves_k, tree_leaves(grads_p))]
    d_loss = abs(float(loss_k) - float(loss_p))
    worst = sorted(zip(rel, leaf_paths(grads_k)), reverse=True)[:3]
    emit(**{label: {"loss": float(loss_k), "plain_loss": float(loss_p),
                    "abs_diff_loss": d_loss, "max_leaf_rel_l2": max(rel),
                    "median_leaf_rel_l2": statistics.median(rel),
                    "worst_leaves": [[p, r] for r, p in worst],
                    "leaves": len(rel), "plain": "K7" if moe_only else "all",
                    "tolerance": [tol_loss, tol_leaf]}})
    check(d_loss <= tol_loss, f"{label}: loss on the kernels "
          f"{float(loss_k)} vs plain {float(loss_p)}")
    check(max(rel) <= tol_leaf, f"{label}: a gradient leaf's relative L2 "
          f"error {max(rel)} > {tol_leaf}")


def train_phase(torch, fa):
    """bench.py's ladder for the large config (TRAIN_RUNGS), each rung on
    fresh copies of the same weights: the first-step loss of every rung at
    batch 8 equals the (8, False, 0) rung's within f32 sum order; one
    gradient on the kernels held against the plain versions at GRAD_RUNG;
    a profiler window over one step of each of PROFILED_RUNGS.
    Returns each kernel's launches over the rungs' steps."""
    trees, total, first = {}, [0] * len(ALL_KERNELS), {}
    for rung in TRAIN_RUNGS:
        row, launches, (model, step, params, state, tokens, targets) = \
            train_rung(torch, fa, rung, trees)
        total = [a + b for a, b in zip(total, launches)]
        first[rung] = row["losses"][0]
        if rung[0] == TRAIN_BATCH:
            check(abs(first[rung] - first[TRAIN_RUNGS[0]]) <= TOL_RUNG_LOSS,
                  f"rung {rung}: first-step loss {first[rung]} vs "
                  f"{first[TRAIN_RUNGS[0]]} at {TRAIN_RUNGS[0]}")
        if rung in PROFILED_RUNGS:
            name = "train_step%s_trace.json" % "".join(
                s for s, on in (("_ce%d" % rung[2], rung[2]),
                                ("_remat", rung[1])) if on)
            train_profile_phase(torch, rung, row["ms_per_step"], step,
                                params, state, tokens, targets, name)
        if rung == GRAD_RUNG:
            grad_vs_plain(torch, fa, "train_vs_plain", model, params, tokens,
                          targets, TOL_STEP_LOSS, TOL_STEP_LEAF)
        del model, step, params, state
    emit(rung_first_losses={str(k): v for k, v in first.items()})
    return tuple(total)


def moe_train_phase(torch, fa):
    """Training at the large config with a top-1 MoE FFN (MOE_EXPERTS,
    capacity factor 1.25) at MOE_RUNG, then one gradient on the kernels
    against the plain versions, then greedy generation from the trained
    model through ``DecodeEngine``. Returns each kernel's launches over the
    training steps."""
    row, launches, (model, step, params, state, tokens, targets) = \
        train_rung(torch, fa, MOE_RUNG, {}, moe=True)
    train_profile_phase(torch, MOE_RUNG, row["ms_per_step"], step, params,
                        state, tokens, targets, "train_step_moe_trace.json",
                        moe=True)
    _loss, aux = model.loss_fn(params, tokens, targets, with_aux=True)
    emit(moe_aux={k: (v.tolist() if v.dim() else float(v))
                  for k, v in aux.items()})
    grad_vs_plain(torch, fa, "moe_train_vs_plain", model, params, tokens,
                  targets, TOL_MOE_STEP_LOSS, TOL_MOE_STEP_LEAF,
                  moe_only=True)
    # the trained MoE model serves through DecodeEngine (paged, greedy)
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    del step, state
    engine = DecodeEngine(model, params, max_len=LARGE["max_len"])
    prompt = np.random.default_rng(SEED + 5).integers(
        0, LARGE["vocab_size"], (2, 100)).astype(np.int32)
    before = all_counts()
    t = time.perf_counter()
    toks = engine.generate(prompt, N_NEW)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    served = tuple(a - b for a, b in zip(all_counts(), before))
    check(toks.shape == (2, N_NEW) and bool(((toks >= 0) & (
        toks < LARGE["vocab_size"])).all()), f"MoE generate: {toks.shape}")
    check(served[6] > 0 and served[7] > 0 and served[4:6] == (0, 0)
          and served[8:10] == (0, 0)
          and served[10:] == ((N_NEW - 1) * LARGE["n_layers"], 0),
          f"MoE generate launched {served} {ALL_KERNELS}")
    emit(moe_generate={"batch": 2, "prompt_len": 100, "new_tokens": N_NEW,
                       "generate_ms": ms,
                       "launches": dict(zip(ALL_KERNELS, served))})
    del model, params, engine
    torch.cuda.empty_cache()
    return launches


def train_profile_phase(torch, rung, step_ms, step, params, state, tokens,
                        targets, trace_name="train_step_trace.json",
                        moe=False):
    """One torch.profiler window over one training step of ``rung``. The
    profiler's own host work stretches the window, so the device's busy
    time is also given over ``step_ms``, the median unprofiled step."""
    L = LARGE["n_layers"]
    reset_all_counts()
    row = profile_window(torch, "train_step",
                         lambda: step(params, state, tokens, targets),
                         trace_name, top=15)
    want = expected_per_step(L, rung[1], rung[2], moe)
    check(all_counts() == want,
          f"profiled step launched {all_counts()}, want {want}")
    if "device_busy_us" in row:
        row["busy_over_unprofiled_step"] = (row["device_busy_us"]
                                            / (1e3 * step_ms))
    emit(train_profile={"rung": list(rung), "moe": moe, **row})


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
    # every kernel of K1 and K2 (the D pass too), and of K3 (its merge
    # too), however small
    attention = {name: tot for name, tot in by_name.items() if re.search(
        r"flash|delta_kernel|dq_kernel|dkdv_kernel", name)}
    cross_entropy = {name: tot for name, tot in by_name.items() if re.search(
        r"ce_wgmma_kernel|ce_fwd_kernel|ce_dlogits_kernel|ce_merge_kernel",
        name)}
    decode = {name: tot for name, tot in by_name.items() if re.search(
        r"paged_attend_kernel|quant_write_kernel", name)}
    return {"wall_ms": wall_ms, "window_us": hi - lo,
            "device_busy_us": busy, "busy_share": busy / (hi - lo),
            "kernels": sum(n for _us, n in by_name.values()),
            "copy_kernels": copies, "trace": str(trace.relative_to(ROOT)),
            "top_kernels": _top(by_name, top), "top_ops": _top(by_op, top),
            "attention_kernels": _top(attention, len(attention)),
            "ce_kernels": _top(cross_entropy, len(cross_entropy)),
            "decode_kernels": _top(decode, len(decode))}


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


def ce_kernel_entry(kind, cases, launches):
    """The kernels-line entry of K3f or K3b: "ce_fwd_wgmma" and
    "ce_dlogits_wgmma" (``chunked_ce_wgmma.cu``) with their numbers at the
    training shape, "ce_fwd" and "ce_dlogits" (``chunked_ce.cu``) at the
    f32 case (CE_MAIN_CASE). K3b's ``ms`` is one launch (one ce chunk);
    ``backward_ms`` is the whole chunked backward (every chunk's K3b and
    its two products), the counterpart of ``library_ms``, the unchunked
    head's backward (a difference of two times). Each entry also carries
    both designs' device times at the training shape, taken in turns."""
    at = CE_MAIN_CASE[kind]
    main = cases[at]
    fwd = kind.startswith("ce_fwd")
    wgmma = kind.endswith("_wgmma")
    p = "fwd" if fwd else "dlogits"
    rows = [r for r in cases.values()
            if r["path"] == ("wgmma" if wgmma else "mma_sync")]
    entry = {
        "name": ("chunked_ce_fwd" if fwd else "chunked_ce_dlogits")
        + ("_wgmma" if wgmma else ""),
        "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}",
        "replaces": "deeplearning4j_tpu/kernels/chunked_ce.py:"
                    + ("40" if fwd else "85"),
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": wgmma,
        "max_abs_err": max(r["max_abs_err_lse" if fwd else
                             "max_abs_err_dlogits"] for r in rows),
        "ms": main[f"{p}_ms"], "device_ms": main[f"{p}_device_ms"],
        "plain_ms": main[f"{p}_plain_ms"], "bound_ms": main[f"{p}_bound_ms"],
        "bound_by": main[f"{p}_bound_by"], "library": main["library"],
        "library_ms": main["library_ms" if fwd else "library_bwd_ms"],
        "library_device_ms": main["library_device_ms" if fwd
                                  else "library_bwd_device_ms"],
        "at": dict(zip(("n", "v", "d", "dtype", "ce_chunks"), at))}
    turns = cases[CE_CASES[0]].get("turns_device_ms")
    if turns is not None:
        entry["turns_device_ms_at_training_shape"] = turns[p]
    if not fwd:
        entry["backward_ms"] = main["backward_ms"]
        entry["backward_device_ms"] = main["backward_device_ms"]
    return entry


def moe_kernel_entry(kind, cases, launches):
    """The kernels-line entry of K7d ("moe_dispatch") or K7c
    ("moe_combine"), its numbers at MOE_CASES[0]."""
    main = cases[MOE_CASES[0]]
    p = "dispatch" if kind == "moe_dispatch" else "combine"
    return {
        "name": kind, "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}",
        "replaces": "deeplearning4j_tpu/parallel/moe.py:"
                    + ("132" if p == "dispatch" else "143"),
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": True,
        "max_abs_err": max(max(r["max_abs_err"][k] for k in
                               (("d_gate",) if p == "dispatch" else
                                ("combine", "dispatch_grad")))
                           for r in cases.values()),
        "ms": main[f"{p}_ms"], "device_ms": main[f"{p}_device_ms"],
        "plain_ms": main[f"{p}_plain_ms"], "bound_ms": main[f"{p}_bound_ms"],
        "bound_by": main[f"{p}_bound_by"], "library": main["library"],
        "library_ms": main[f"{p}_library_ms"],
        "library_device_ms": main[f"{p}_library_device_ms"],
        "at": dict(zip(("g", "e", "c", "top_k", "d", "dtype"),
                       MOE_CASES[0]))}


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
    for name in ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma",
                 "chunked_ce_wgmma"):
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
    log = _build.build_logs.get("chunked_ce_wgmma")
    if log is not None:
        report = ce_wgmma_ptxas(log)
        emit(ce_wgmma_ptxas=report)
        check(sorted(report) == ["dlogits", "fwd"]
              and all("registers" in r and r.get("spill_bytes") == 0
                      for r in report.values()),
              f"wgmma K3: want no spills in its two kernels, ptxas gave "
              f"{report}")
    log = _build.build_logs.get("paged_attention")
    if log is not None:
        report = k4a_ptxas(log)
        emit(k4a_ptxas=report)
        check(spill_free(report, K4A_INSTANTIATIONS),
              f"K4a: want no spills in its {len(K4A_INSTANTIATIONS)} "
              f"instantiations, ptxas gave {report}")

    def allocated(after):
        emit(allocated={"after": after,
                        "bytes": torch.cuda.memory_allocated()})

    cases = kernel_phase(torch, fa)
    allocated("kernel_phase")
    bwd_cases = bwd_phase(torch, fa)
    allocated("bwd_phase")
    head_phase(torch)
    allocated("head_phase")
    ce_cases = ce_phase(torch)
    allocated("ce_phase")
    moe_cases = moe_phase(torch)
    allocated("moe_phase")
    decode_cases = decode_kernel_phase(torch)
    allocated("decode_kernel_phase")
    torch.cuda.empty_cache()
    engine, _model, serve = slice_phase(torch, fa)
    profile_phase(torch, fa, engine)
    decode_profile_phase(torch, engine)
    modes = serve_phase(torch, _model, engine)
    del engine, _model
    torch.cuda.empty_cache()
    allocated("slice_phase")
    train = train_phase(torch, fa)
    moe = moe_train_phase(torch, fa)
    launches = {name: {"serve": serve[i], "serve_modes": modes[i],
                       "train": train[i], "moe": moe[i]}
                for i, name in enumerate(ALL_KERNELS)}
    emit(main_path_launches=launches)
    check(serve[0] > 0 and train[0] > 0 and moe[0] > 0,
          "a main path launched no flash_attention_fwd_wgmma")
    check(train[2] > 0 and moe[2] > 0,
          "training launched no flash_attention_bwd_wgmma")
    check(serve[1] == 0 and train[1] == 0 and moe[1] == 0,
          "a main path launched the simple kernel")
    check(serve[2] == serve[3] == train[3] == moe[3] == 0,
          "serving launched a backward, or training the mma.sync one")
    check(all(n > 0 for n in train[8:10] + moe[6:10]),
          f"training launched no wgmma K3f or K3b, K7d or K7c: {train}, "
          f"{moe}")
    check(train[4:6] == moe[4:6] == (0, 0),
          "bf16 training launched chunked_ce.cu's K3 kernels")
    check(serve[4:10] == modes[4:10] == (0,) * 6 and train[6:8] == (0, 0),
          "serving launched K3 or K7, or the dense model K7")
    check(serve[10] > 0 and serve[11] == 0 and modes[10] > 0
          and modes[11] > 0 and train[10:] == moe[10:] == (0, 0),
          f"K4a or K4w off their paths: serve {serve[10:]}, modes "
          f"{modes[10:]}, train {train[10:]}, moe {moe[10:]}")
    emit(kernels=[kernel_entry("wgmma", cases, launches["wgmma"]),
                  kernel_entry("simple", cases, launches["simple"]),
                  bwd_kernel_entry("bwd_wgmma", bwd_cases,
                                   launches["bwd_wgmma"]),
                  bwd_kernel_entry("bwd", bwd_cases, launches["bwd"]),
                  ce_kernel_entry("ce_fwd", ce_cases, launches["ce_fwd"]),
                  ce_kernel_entry("ce_dlogits", ce_cases,
                                  launches["ce_dlogits"]),
                  moe_kernel_entry("moe_dispatch", moe_cases,
                                   launches["moe_dispatch"]),
                  moe_kernel_entry("moe_combine", moe_cases,
                                   launches["moe_combine"]),
                  ce_kernel_entry("ce_fwd_wgmma", ce_cases,
                                  launches["ce_fwd_wgmma"]),
                  ce_kernel_entry("ce_dlogits_wgmma", ce_cases,
                                  launches["ce_dlogits_wgmma"]),
                  decode_kernel_entry("paged_attention", decode_cases,
                                      launches["paged_attention"]),
                  decode_kernel_entry("kv_quant_write", decode_cases,
                                      launches["kv_quant_write"])])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
