#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``kernels/csrc/`` with
``nvcc`` (one process per source, all at once), checks in ptxas's report
that the wgmma forward has 168 registers a thread at entry and no spills,
that the wgmma backward's and the wgmma and tf32 K3's kernels, every
instantiation of the mma.sync flash forward and backward, of K4a and of
K4w spill nothing, and that no wgmma source has its products serialized
(C7514/C7512), then:

1. kernel phase — holds each flash-attention kernel (the wgmma kernel for
   bf16 at d 64/128, the simple kernel for f32 and the other head dims, any
   d % 8 == 0 in [8, 256]) against its plain PyTorch version on the card,
   at the main path's shapes and layouts (the strided fused-QKV views, the
   batch bucket, the ragged ``apply`` length, block edges, non-causal with
   Tq != Tk, d 128; in f32 the f32 model's prefill and training layer; bf16
   at d 32, 80, 96, 256; d 8, 40, 136 and 256 in both types), and times
   each: ``ms`` (20 back-to-back wrapper calls between CUDA
   events, host included), ``device_ms`` (20 launches captured in a CUDA
   graph, replays timed with CUDA events: device only), the plain
   version, SDPA (``library_ms`` and ``library_device_ms``, timed the same
   two ways) and the card's bound (f32 at 165 TFLOP/s, three TF32 products
   at the 495 TFLOP/s peak, with the 67 TFLOP/s FMA bound beside);
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
   K3b; the wgmma kernels for bf16, the tf32 kernels and their split pass
   for f32, and chunked_ce.cu's in turns against each at its training
   shape) and K7 (MoE dispatch K7d and
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
   step and the verify window (``decode_split_sweep``); then K4a+w (the
   decode step's store in K4a's launch, every decode path's kernel) on
   bf16, int8 and f32 pages and the dense cache, against its plain version
   (o at K4a's tolerance) and against the two-launch path it replaces (the
   store's own launch, then K4a: o and every pool byte the same, the trash
   page aside), timed in turns with that path at the decode step and B 8,
   W 5; K4w (the prefill insert's, first) beside its bound;
3. slice phase — serves generation from ``TransformerLM`` at the full
   width of the bench's large config (vocab 32768, 12 layers, 16 heads,
   d_model 1024, d_ff 4096, max_len 1024, bf16, fused QKV; random weights
   from a numpy seed through ``from_jax_params``) through ``DecodeEngine``
   in its default paged mode, checks the tokens and logits, and checks that
   every prefill and ``apply`` launched the wgmma kernel exactly once per
   layer and the simple kernel never, and every decode step K4a+w once per
   layer (K4a alone and K4w never);
4. profile phase — one ``torch.profiler`` window over a single prefill at
   bucket 1024, and one over 4 decode steps after a 960-token prompt on
   bf16 pages and one on int8 pages: the device's busy share, kernels a
   step and the top device kernels; then the serving modes
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
   greedy generation from the trained model through ``DecodeEngine``;
7. f32 phase — the same config in f32, the model's default compute type:
   one request served on f32 pages (a bucket-1024 prefill through the
   simple forward, 32 greedy tokens through K4a, the decode logits held to
   ``apply``), then rungs (8, no, 0) and (8, no, 8) (2 warm and 3 timed
   steps, a profiled step each; the simple forward, the mma.sync / FMA
   backward and the tf32 K3 with its split pass on every step, no wgmma
   flash kernel and chunked_ce.cu's K3 never) and one full-width gradient
   on the kernels against the plain versions.

Every phase must pass: any failure exits nonzero. Output is one JSON
object per line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or outside a checkout, it exits nonzero and prints no result.

``python3 chip_smoke.py --compare-bwd OTHER`` instead times K2 (and K1 at
its main shapes) in this tree and in the checkout at OTHER in turns
(OTHER, this, this, OTHER), each turn a subprocess running that tree's
``kernel_phase`` and ``bwd_phase`` on the bf16 d 64/128 cases, and prints
each case's device ms per turn; ``--compare-f32 OTHER`` does the same for
the simple forward and the mma.sync / FMA backward at F32_COMPARE_CASES.
``--precision-f32`` holds the f32 kernels and the plain versions against
f64 at the f32 shapes; ``--precision-ce-f32`` holds the f32 K3 (the scalar
FMA kernel of chunked_ce.cu and the tf32 one) and its plain versions
against f64 at the f32 training shape, and times both kernels in turns.
``--compare-decode OTHER`` profiles and times decode steps over bf16 and
int8 pages at the large config here and in the checkout at OTHER in turns
(kernels a step, device busy time a step, host ms a step).
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
    # the simple kernel: f32 (the table's shape, the f32 model's prefill and
    # its training layer), and bf16 at other head dims
    ("3d", 16, 1, 256, 256, 64, "float32", True),
    ("fused", 1, 16, 1024, 1024, 64, "float32", True),
    ("fused", 8, 16, 1024, 1024, 64, "float32", True),
    ("3d", 16, 1, 512, 512, 32, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 80, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 96, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 256, "bfloat16", True),
    ("fused", 1, 8, 129, 129, 80, "bfloat16", True),
    # head dims the kernels took from PR 9 on: 8, 40 (d % 16 == 8), 136 and
    # 256 (tile width 192 and 256), both types
    ("fused", 2, 4, 130, 130, 8, "float32", True),
    ("fused", 2, 4, 130, 130, 8, "bfloat16", True),
    ("3d", 8, 1, 200, 200, 40, "float32", True),
    ("3d", 8, 1, 200, 200, 40, "bfloat16", False),
    ("fused", 1, 2, 150, 150, 136, "float32", True),
    ("3d", 4, 1, 300, 77, 256, "float32", False),
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
# the four flash kernels, then K3f and K3b of chunked_ce.cu (bf16 at other
# d; its f32 kernel, on no path since the tf32 one), K7d and K7c, then the
# wgmma K3f and K3b (bf16 at d % 64 == 0), then K4a (paged decode attention)
# and K4w (int8 quantize-and-scatter), then the tf32 K3f and K3b (f32) and
# their operands' split pass, then K4a+w (the decode store in K4a's launch)
ALL_KERNELS = KERNELS + ("ce_fwd", "ce_dlogits", "moe_dispatch",
                         "moe_combine", "ce_fwd_wgmma", "ce_dlogits_wgmma",
                         "paged_attention", "kv_quant_write", "ce_fwd_tf32",
                         "ce_dlogits_tf32", "ce_split_tf32",
                         "paged_attention_write")
SOURCES.update(ce_fwd="chunked_ce.cu", ce_dlogits="chunked_ce.cu",
               moe_dispatch="moe_route.cu", moe_combine="moe_route.cu",
               ce_fwd_wgmma="chunked_ce_wgmma.cu",
               ce_dlogits_wgmma="chunked_ce_wgmma.cu",
               paged_attention="paged_attention.cu",
               kv_quant_write="paged_attention.cu",
               ce_fwd_tf32="chunked_ce_tf32.cu",
               ce_dlogits_tf32="chunked_ce_tf32.cu",
               ce_split_tf32="chunked_ce_tf32.cu",
               paged_attention_write="paged_attention.cu")
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
    # f32 at the f32 model's prefill shape and its training layer; bf16 at
    # d 80, 96 and 256; the head dims taken from PR 9 on
    ("fused", 1, 16, 1024, 1024, 64, "float32", True),
    ("fused", 8, 16, 1024, 1024, 64, "float32", True),
    ("3d", 16, 1, 512, 512, 80, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 96, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 256, "bfloat16", True),
    ("fused", 2, 4, 130, 130, 8, "float32", True),
    ("fused", 2, 4, 130, 130, 8, "bfloat16", True),
    ("3d", 8, 1, 200, 200, 40, "float32", True),
    ("3d", 8, 1, 200, 200, 40, "bfloat16", False),
    ("fused", 1, 2, 150, 150, 136, "float32", True),
    ("3d", 4, 1, 300, 77, 256, "float32", False),
]
BWD_MAIN_CASE = {"bwd_wgmma": BWD_CASES[0], "bwd": BWD_CASES[7]}
# the bench's large config (bench.py, the "large" rung)
LARGE = dict(vocab_size=32768, n_layers=12, n_heads=16, d_model=1024,
             d_ff=4096, max_len=1024, dtype="bfloat16", fused_qkv=True)
# the model's default compute type: the same config in f32 (f32 pages when
# serving), the path of the simple forward and the mma.sync backward
LARGE_F32 = dict(LARGE, dtype="float32")
F32_RUNGS = ((8, False, 0), (8, False, 8))
F32_TIMED_STEPS = 3
# tolerances (PERF.md states the reasons): kernel vs plain version on the
# same inputs, and decode logits vs the full forward over the same tokens
TOL_O = {"bfloat16": 2e-2, "float32": 5e-5}
TOL_LSE = 1e-3
TOL_TEACHER_FORCED = 0.1
# the f32 model's decode logits against apply: set from readings on the
# H100 (PERF.md) between a sound run's (2.35e-5: f32 sums in another order
# through 12 layers, the split forward's o within ~6e-6 of the plain
# version's) and a control's whose forward rounds its operands to TF32
# alone (3.55e-4), 4x over the one and 3.5x under the other
TOL_TEACHER_FORCED_F32 = 1e-4
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
# the same for the f32 model at (8, no, 8). The loss, near 9, is a mean
# whose own f32 rounding (an ulp is 9.5e-7 there) is all a run can read:
# sound runs read 2-3 ulps, the TF32-alone control 1, so its limit (5
# ulps) only catches gross faults. The leaves tell precision apart: set
# from readings on the H100 (PERF.md) between sound runs' (1.28e-5,
# 1.32e-5) and the control's (1.61e-4), 4x over the one and 3x under the
# other
TOL_STEP_LOSS_F32 = 5e-6
TOL_STEP_LEAF_F32 = 5e-5
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
# the first is the training layer (bench large config, batch 8), the last
# the same in f32 (the f32 model's training layer). The bf16 cases take the
# wgmma kernels, the f32 ones the tf32 kernels (the small one ragged-free
# but many splits)
CE_CASES = [
    (8192, 32768, 1024, "bfloat16", 8),
    (4096, 32768, 1024, "bfloat16", 8),      # batch 4
    (1000, 5000, 1024, "bfloat16", 4),       # ragged rows and vocab
    (1, 384, 64, "bfloat16", 3),
    (1024, 4096, 256, "float32", 4),
    (8192, 32768, 1024, "float32", 8),
]
# the case each K3 kernel's kernels-line numbers come from: the training
# shape of its type (chunked_ce.cu's, on no path for f32, from its
# turns against the tf32 kernels there)
CE_MAIN_CASE = {"ce_fwd_wgmma": CE_CASES[0], "ce_dlogits_wgmma": CE_CASES[0],
                "ce_fwd": CE_CASES[5], "ce_dlogits": CE_CASES[5],
                "ce_fwd_tf32": CE_CASES[5], "ce_dlogits_tf32": CE_CASES[5],
                "ce_split_tf32": CE_CASES[5]}
# where chunked_ce.cu's kernels are forced onto the operands and timed in
# turns against the kernels that take them: the bf16 and f32 training
# shapes
CE_TURN_CASES = (CE_CASES[0], CE_CASES[5])
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
# an all-zero row. The first is the main path's, the insert at bucket 1024
# (since K4a+w stores the decode rows, K4w's only caller).
QUANT_CASES = [
    (1, 1024, 12, 64, "bfloat16"),      # the insert at bucket 1024
    (1, 32, 12, 64, "bfloat16"),        # bucket 32 into one padded page
    (1, 1, 1, 64, "bfloat16"),
    (1, 5, 1, 64, "bfloat16"),
    (8, 5, 1, 64, "bfloat16"),
    (2, 5, 1, 16, "float32"),
]
# K4a+w cases (DECODE_CASES' shapes, the window's rows stored in the
# launch): bf16 pages, int8 pages and the dense cache at the decode step,
# the verify window at B 8, a window past S with a free slot, f32 pages.
# The first three, and B 8 W 5 on bf16 pages, are timed in turns against
# the two-launch path (the store's own launch, then K4a).
FUSED_CASES = [DECODE_CASES[0], DECODE_CASES[7], DECODE_CASES[11],
               DECODE_CASES[6], DECODE_CASES[10], DECODE_CASES[12],
               DECODE_CASES[17], DECODE_CASES[16]]
FUSED_TURN_CASES = FUSED_CASES[:4]
FUSED_MAIN_CASE = {"paged_attention_write": DECODE_CASES[0],
                   "int8": DECODE_CASES[7], "dense": DECODE_CASES[11]}
# the serving modes at full width: int8 pages with plain decode, bf16 pages
# with speculative decoding (a 2-layer truncated draft with a dense cache,
# spec_k 4), and both
SPEC_K = 4
DRAFT_LAYERS = 2
# the first-step loss of a rung with ce_chunks (or remat) against the same
# batch and weights at (8, False, 0): f32 sums in another order
TOL_RUNG_LOSS = 5e-5
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA
# (the training step's f32 GEMMs run there: TF32 is off), device memory
# bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the rate f32 products on the tensor cores could run at (attention's and
# K3's): three TF32 products (the split that keeps f32 accuracy) at the
# 495 TFLOP/s dense TF32 peak
ATTN_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
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


def _bound(flops, nbytes, dtype, peaks=None):
    t_ops = flops / (PEAK_FLOPS if peaks is None else peaks)[dtype]
    t_mem = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def attention_bound_ms(bh, t_q, t_k, d, dtype, causal, peaks=None):
    """Least time for one call: the larger of its FLOPs over the peak
    rate of its type (``ATTN_PEAK_FLOPS``: f32 at a third of the TF32
    rate, or ``peaks``) and its bytes (q, k, v read once, o and lse
    written once) over the memory rate. Causal counts only the kept pairs
    (k_idx <= q_idx)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * bh * d * _kept_pairs(t_q, t_k, causal)
    nbytes = itemsize * bh * d * 2 * (t_q + t_k) + 4 * bh * t_q
    return _bound(flops, nbytes, dtype, peaks or ATTN_PEAK_FLOPS)


def attention_bwd_bound_ms(bh, t_q, t_k, d, dtype, causal, peaks=None):
    """Least time for one backward call: the five products of
    ``_bwd_blockwise`` (S = QKᵀ, dV = PᵀdO, dP = dO·Vᵀ, dQ = dS·K,
    dK = dSᵀQ), 2·d FLOPs per kept pair each, over the peak rate of the
    type (as :func:`attention_bound_ms`), against q, k, v, o, dO and lse
    read once and dq, dk, dv written once over the memory rate."""
    itemsize = 2 if dtype == "bfloat16" else 4
    flops = 10.0 * bh * d * _kept_pairs(t_q, t_k, causal)
    nbytes = itemsize * bh * d * 4 * (t_q + t_k) + 4 * bh * t_q
    return _bound(flops, nbytes, dtype, peaks or ATTN_PEAK_FLOPS)


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


K4W_INSTANTIATIONS = ["bf16", "f32"]


def k4a_readonly_loads(sass):
    """{function: 64- and 128-bit loads through the read-only path} for
    each K4a instantiation in ``cuobjdump -sass`` output. K4a+w reads back
    rows its block stored in the same launch, which that path need not
    see, so the pool loads must take the coherent one: every count 0."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "paged_attend_kernel" in name:
            out[name] = len(re.findall(
                r"LDG\.E\.(?:64|128)\.CONSTANT|LDG\.E\.CONSTANT\.(?:64|128)",
                fn))
    return out


def k4w_ptxas(log):
    """{"bf16": {...}, "f32": {...}}: K4w's ``quant_write_kernel<T>``."""
    return _ptxas(log, r"quant_write_kernelI(13__nv_bfloat16|f)E",
                  lambda m: "f32" if m.group(1) == "f" else "bf16")


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


def ce_tf32_ptxas(log):
    """{"fwd"|"dlogits"|"split": {"registers": n, "spill_bytes": n}} for
    the kernels of ``chunked_ce_tf32.cu``: K3f and K3b
    (``ce_tf32_kernel<DLOGITS>``) and the split pass."""
    return _ptxas(
        log, r"ce_split_kernel|ce_tf32_kernelILb([01])E",
        lambda m: "split" if m.group(1) is None else
        "dlogits" if m.group(1) == "1" else "fwd")


CE_TF32_INSTANTIATIONS = ["dlogits", "fwd", "split"]


# every instantiation of the mma.sync / FMA flash kernels: the forward at
# each (dtype, tile width), the backward's dQ and dK/dV kernels at each, and
# its D pass at each dtype
SIMPLE_WIDTHS = (32, 64, 96, 128, 192, 256)
SIMPLE_INSTANTIATIONS = sorted(f"{t} w{w}" for t in ("f32", "bf16")
                               for w in SIMPLE_WIDTHS)
BWD_INSTANTIATIONS = sorted(
    [f"{k} {t} w{w}" for k in ("dq", "dkdv") for t in ("f32", "bf16")
     for w in SIMPLE_WIDTHS] + ["delta f32", "delta bf16"])


def _dtype_name(mangled):
    return "f32" if mangled == "f" else "bf16"


def simple_ptxas(log):
    """{"f32 w64": {"registers": n, "spill_bytes": n}, ...} for each
    instantiation of ``flash_attention_fwd.cu``'s kernel."""
    return _ptxas(log, r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                  lambda m: f"{_dtype_name(m.group(1))} w{m.group(2)}")


def bwd_ptxas(log):
    """{"dq f32 w64": {...}, "delta bf16": {...}, ...} for each kernel of
    ``flash_attention_bwd.cu``."""
    return _ptxas(log, r"(dq|dkdv|delta)_kernelI(f|13__nv_bfloat16)"
                  r"(?:Li(\d+)E)?",
                  lambda m: f"{m.group(1)} {_dtype_name(m.group(2))}"
                  + (f" w{m.group(3)}" if m.group(3) else ""))


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
        path = fa.kernel_for(q.dtype, d)
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
        if dtype == "float32":      # the bound at the f32 FMA rate beside
            row["bound_fma_ms"] = attention_bound_ms(
                b * h, t_q, t_k, d, dtype, causal, peaks=PEAK_FLOPS)[0]
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
        path = ("bwd_wgmma" if fa.kernel_for(q.dtype, d) == "wgmma"
                else "bwd")
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
        if dtype == "float32":
            row["bound_fma_ms"] = attention_bwd_bound_ms(
                b * h, t_q, t_k, d, dtype, causal, peaks=PEAK_FLOPS)[0]
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
                         pa.launches_attend, pa.launches_quant_write,
                         ce.launches_fwd_tf32, ce.launches_dlogits_tf32,
                         ce.launches_split_tf32, pa.launches_attend_write)


def reset_all_counts():
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    reset_counts(fa)
    ce.launches_fwd = ce.launches_dlogits = 0
    ce.launches_fwd_wgmma = ce.launches_dlogits_wgmma = 0
    ce.launches_fwd_tf32 = ce.launches_dlogits_tf32 = 0
    ce.launches_split_tf32 = 0
    mr.launches_dispatch = mr.launches_combine = 0
    pa.launches_attend = pa.launches_quant_write = 0
    pa.launches_attend_write = 0


def launch_counts(**named):
    """A launch tuple in ALL_KERNELS' order: the ``named`` kernels' counts,
    0 for every other kernel."""
    unknown = set(named) - set(ALL_KERNELS)
    if unknown:
        raise ValueError(f"no such kernels: {sorted(unknown)}")
    return tuple(named.get(k, 0) for k in ALL_KERNELS)


def delta(before):
    """Each kernel's launches since ``before`` (an ``all_counts()``)."""
    return tuple(a - b for a, b in zip(all_counts(), before))


def ce_fwd_bound_ms(n, v, d, dtype, peaks=None):
    """K3f's least time: 2·N·V·d FLOPs of the logits over the peak of the
    type (``ATTN_PEAK_FLOPS``: f32 as three TF32 products at a third of the
    TF32 rate, or ``peaks``), against x and E read once, targets read and
    lse written once."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(2.0 * n * v * d, item * (n + v) * d + 8 * n + 4 * n + 4,
                  dtype, peaks or ATTN_PEAK_FLOPS)


def ce_dlogits_bound_ms(n, c, d, dtype, peaks=None):
    """One K3b launch's least time: 2·N·C·d FLOPs (over the peak as in
    :func:`ce_fwd_bound_ms`) against x, the chunk of E, targets and lse
    read once and the (N, C) dlogits written once."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(2.0 * n * c * d,
                  item * (n + c) * d + 12 * n + item * n * c, dtype,
                  peaks or ATTN_PEAK_FLOPS)


def ce_split_bound_ms(n, v, d):
    """The split pass's least time: x (N, d) and E (V, d) in f32 read
    once and their two TF32 parts, rows of d rounded up to 32, written
    once, over the memory rate (no arithmetic to speak of)."""
    dp = -(-d // 32) * 32
    return _bound(0.0, 4 * (n + v) * (d + 2 * dp), "float32")


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
    suffix = {"wgmma": "_wgmma", "tf32": "_tf32", "mma_sync": ""}[path]
    reset_all_counts()
    lse, loss = ce.chunked_ce_fwd(x, e, t, chunks, kernel=kernel)
    torch.cuda.synchronize()
    want = [0] * len(ALL_KERNELS)
    want[ALL_KERNELS.index("ce_fwd" + suffix)] = 1
    if path == "tf32":              # the operands' split pass first
        want[ALL_KERNELS.index("ce_split_tf32")] = 1
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
    check(all_counts()[ALL_KERNELS.index("ce_dlogits" + suffix)] == 1,
          f"K3b {case} ({path}): did not launch")
    local = torch.where(t < c, t, -1)
    rel, at = dlogits_errors(dlog, ref, local, 1.0 / n)
    check(rel <= TOL_CE_DLOG_L2[dtype] and at <= TOL_CE_DLOG_TARGET[dtype],
          f"K3b {case} ({path}): relative L2 off the targets {rel}, at the "
          f"targets {at} of g/N")
    err_dlog = (dlog.float() - ref.float()).abs().max().item()
    return path, err_lse, err_loss, err_dlog, rel, at


def ce_phase(torch):
    """K3f and K3b against their plain versions at each of CE_CASES (the
    wgmma kernels on the bf16 cases, the tf32 kernels and their split pass
    on the f32 ones), timed as the flash kernels are. K3f's library time is
    the unchunked path it replaces, two calls: the tied head's product into
    f32 logits (``_TiedHead``, or the f32 product with TF32 off) and
    logsumexp minus the gathered target logit; K3b's is that path's
    backward (the f32 dlogits, then the head's backward), as the
    difference of its forward + backward and its forward. K3b itself is
    timed per launch (one ce chunk, on parts split beforehand where the
    kernel is tf32, as the backward does) and as the whole chunked backward
    (the split, every chunk's K3b and its two products). At the two
    training shapes (CE_TURN_CASES) chunked_ce.cu's kernels also run on the
    same operands, held to the plain versions too, and both designs'
    device times are taken in turns (mma.sync, new, new, mma.sync). The
    split pass is held to its plain version bit for bit and timed at the
    f32 cases."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.models.transformer import _TiedHead
    # the yardstick's f32 products are f32 (the port's TF32 policy)
    torch.backends.cuda.matmul.allow_tf32 = False
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
        tf32 = path == "tf32"
        parts = ce.split_tf32(x, e) if tf32 else None
        parts0 = parts[:2] + tuple(p[:c] for p in parts[2:]) if tf32 \
            else None

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
            ce.ce_dlogits(x, e0, t, lse_ref, 0, gr, n, kernel=kernel,
                          parts=parts0 if kernel is None else None)

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
               "library": ("_TiedHead (torch.mm out_dtype=f32)"
                           if dt == torch.bfloat16 else
                           "f32 product (TF32 off)")
               + " + logsumexp - gather; its backward",
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
        if dtype == "float32":      # the bounds at the f32 FMA rate beside
            row["fwd_bound_fma_ms"] = ce_fwd_bound_ms(n, v, d, dtype,
                                                      PEAK_FLOPS)[0]
            row["dlogits_bound_fma_ms"] = ce_dlogits_bound_ms(
                n, c, d, dtype, PEAK_FLOPS)[0]
        row["fwd_device_vs_bound"] = row["fwd_device_ms"] / row[
            "fwd_bound_ms"]
        row["backward_device_vs_bound"] = row["backward_device_ms"] / (
            chunks * row["dlogits_bound_ms"])
        if tf32:
            want = ce.split_tf32_reference(x) + ce.split_tf32_reference(e)
            exact = all(torch.equal(a.view(torch.int32),
                                    b.view(torch.int32))
                        for a, b in zip(parts, want))
            check(exact, f"split pass {case}: not its plain version's bits")
            del want
            row["split"] = {
                "exact": exact, "ms": time_ms(lambda: ce.split_tf32(x, e),
                                              torch),
                "device_ms": device_ms(lambda: ce.split_tf32(x, e), torch),
                "plain_ms": time_ms(
                    lambda: (ce.split_tf32_reference(x),
                             ce.split_tf32_reference(e)), torch, iters=3,
                    repeats=3)}
            row["split"]["bound_ms"], row["split"]["bound_by"] = \
                ce_split_bound_ms(n, v, d)
        if case in CE_TURN_CASES:
            # chunked_ce.cu's kernels on the same operands: held to the
            # plain versions, then both designs timed in turns
            _p, *errs = ce_checked(torch, ce, case, x, e, t, lse_ref, cor,
                                   kernel="mma_sync")
            old = dict(zip(
                ("max_abs_err_lse", "abs_err_loss", "max_abs_err_dlogits",
                 "dlogits_rel_l2_off_target",
                 "dlogits_err_at_target_over_scale"), errs))
            old["fwd_ms"] = time_ms(lambda: fwd("mma_sync"), torch)
            old["dlogits_ms"] = time_ms(lambda: dlogits("mma_sync"), torch)
            turns = {"fwd": {"mma_sync": [], path: []},
                     "dlogits": {"mma_sync": [], path: []}}
            for kernel in ("mma_sync", path, path, "mma_sync"):
                for what, fn in (("fwd", fwd), ("dlogits", dlogits)):
                    turns[what][kernel].append(device_ms(
                        lambda: fn(None if kernel == path else kernel),
                        torch))
            for what in ("fwd", "dlogits"):
                old[f"{what}_device_ms"] = statistics.median(
                    turns[what]["mma_sync"])
            row["mma_sync"] = old
            row["turns_device_ms"] = turns
        emit(ce_case=row)
        results[case] = row
        del parts, parts0
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
    attention forward and backward, K3f, K3b and the split pass, K7d and
    K7c), or of K7's
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
                  (ce, "ce_dlogits", ce.ce_dlogits),
                  (ce, "split_tf32", ce.split_tf32)]

        def ce_fwd(x2, emb, targets, n_chunks):
            lse, correct = ce.chunked_ce_fwd_reference(x2, emb, targets,
                                                       n_chunks)
            return lse, (lse - correct).mean()

        def ce_dlogits(*args, parts=None, **kw):
            return ce.ce_dlogits_reference(*args, **kw)

        # no split pass: the backward then hands K3b no parts
        ce.chunked_ce_fwd, ce.ce_dlogits = ce_fwd, ce_dlogits
        ce.split_tf32 = lambda x2, emb: None
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


def expected_per_step(n_layers, remat, ce_chunks, moe=False, f32=False):
    """Launches of each kernel (ALL_KERNELS' order) in one training step of
    the large config: in bf16 the wgmma forward once per layer (twice
    under remat: the recompute), the wgmma backward once per layer, the
    wgmma K3f once and K3b once per ce chunk when ce_chunks (chunked_ce.cu's
    never: d 1024 is a multiple of 64); in f32 (``f32``) the simple forward
    and the mma.sync / FMA backward in their places, and the tf32 K3f once,
    K3b once per ce chunk and the split pass twice (once for the forward,
    once before the backward's chunks; chunked_ce.cu's K3 never); for a MoE
    model K7d and K7c twice per layer (the forward's dispatch and combine,
    and each one's backward in the other kernel; three times under remat);
    K4a, K4w and K4a+w (decode only) never."""
    L = n_layers
    k7 = (3 if remat else 2) * L if moe else 0
    fwd, k3f = (2 if remat else 1) * L, 1 if ce_chunks else 0
    if f32:
        return launch_counts(simple=fwd, bwd=L, moe_dispatch=k7,
                             moe_combine=k7, ce_fwd_tf32=k3f,
                             ce_dlogits_tf32=ce_chunks,
                             ce_split_tf32=2 if ce_chunks else 0)
    return launch_counts(wgmma=fwd, bwd_wgmma=L, moe_dispatch=k7,
                         moe_combine=k7, ce_fwd_wgmma=k3f,
                         ce_dlogits_wgmma=ce_chunks)


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
    # the wgmma forward once per layer of a prefill or apply, K4a+w once
    # per layer of each decode step (bf16 pages: K4w never), nothing else
    per_forward = launch_counts(wgmma=L)
    per_generate = launch_counts(wgmma=L,
                                 paged_attention_write=(N_NEW - 1) * L)
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
    return _bound(*k4a_bound_parts(case, pos), "float32")


def k4a_bound_parts(case, pos):
    """(operations, bytes) of :func:`k4a_bound_ms`."""
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
    return flops, nbytes


def k4w_bound_ms(n_valid, n_rows, layers, c, dtype):
    """K4w's least time: the k and v rows read once, their int8 rows and
    f32 scales written once, and the (page, row) coordinates read (no
    arithmetic to speak of)."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(0.0, layers * (2 * n_valid * c * item + 2 * n_rows * c
                                 + 8 * n_rows) + 8 * n_rows, dtype)


def k4aw_inputs(torch, case):
    """K4a's inputs for one of DECODE_CASES (a P = S case as the dense
    cache: B pages of S tokens, no trash page), with q and the window's k
    and v rows as strided views of one projection, and each row's flat
    pool row ``dst``: through the table, past S to the trash page (paged)
    or dropped (-1, dense). Returns (q, k, v, pools, tables, pos, dst,
    dense)."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
    _q, pools, tables, pos = k4_inputs(torch, case)
    dense = n_lp == 1 and not trash and pool != "int8"
    C, S = H * hd, P * n_lp
    g = torch.Generator(device="cuda").manual_seed(B * 29 + W + hd + P)
    proj = torch.randn((B, W, 3 * C), generator=g, device="cuda").to(
        getattr(torch, dtype))
    q, k, v = (proj[..., i * C:(i + 1) * C].view(B, W, H, hd)
               for i in range(3))
    pos64 = pos.long()
    if dense:
        tables = pa.dense_tables(B, "cuda")
        pools = (pools[0][:B].contiguous(), pools[1][:B].contiguous(),
                 None, None)
        dst = torch.where(pos64 < S, torch.arange(
            B, device="cuda")[:, None] * S + pos64, -1)
    else:
        lp = (pos64 // P).clamp(max=n_lp - 1)
        page = torch.where(pos64 < S, tables.long().gather(1, lp),
                           pools[0].shape[0] - 1)
        dst = page * P + pos64 % P
    return q, k, v, pools, tables, pos, dst.to(torch.int32), dense


def two_launch_store(torch, k, v, pools, dst):
    """The store K4a+w folds in, as the decode path ran it before: K4w on
    int8 pools, else one ``index_put_`` of the rows into each pool (the
    kept rows gathered first where some are dropped; integer indices made
    here, once: CUDA-graph safe). Returns a function of no arguments doing
    it in place."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    kp, vp, ks, vs = pools
    if ks is not None:
        P = kp.shape[1]
        phys, off = dst // P, dst % P
        return lambda: pa.kv_quant_write(k, v, phys, off, kp, vp, ks, vs)
    flat_k = kp.view(-1, *kp.shape[2:])
    flat_v = vp.view(-1, *vp.shape[2:])
    if bool((dst >= 0).all()):
        at = dst.long()

        def store():
            flat_k[at] = k
            flat_v[at] = v
        return store
    bi, wi = torch.nonzero(dst >= 0, as_tuple=True)
    at = dst.long()[bi, wi]

    def store_kept():
        flat_k[at] = k[bi, wi]
        flat_v[at] = v[bi, wi]
    return store_kept


def k4aw_bound_ms(case, pos, dst):
    """K4a+w's least time: K4a's (:func:`k4a_bound_ms`) plus the window's k
    and v rows read once from the projection, the stored rows written once
    (int8 rows with their f32 scales) and their pool rows ``dst`` read."""
    B, W, H, hd, P, n_lp, dtype, pool, _ctx, _trash = case
    item = 2 if dtype == "bfloat16" else 4
    kv_item = 1 if pool == "int8" else item
    stored = int((dst >= 0).sum().item())
    flops, nbytes = k4a_bound_parts(case, pos)
    nbytes += (2 * B * W * H * hd * item + 4 * B * W
               + 2 * stored * (H * hd * kv_item + (4 if pool == "int8"
                                                   else 0)))
    return _bound(flops, nbytes, "float32")


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
    for case in FUSED_CASES:
        results[("fused",) + case] = fused_decode_case(torch, case)
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


def fused_decode_case(torch, case):
    """K4a+w at one of FUSED_CASES: o of the live slots the same bits as
    the two-launch path's (the store's own launch, then K4a) and within
    TOL_O of the plain version's (the scatter, the gather and the
    reference attention); the pools and scales the same bytes as both,
    the trash page aside (free slots and rows past S write it in no fixed
    order); the same bits on a second call and across CUDA-graph replays.
    Times it (``device_ms`` from graph replays, ``ms`` with the host), the
    two-launch path in turns with it (fused, two, two, fused) at
    FUSED_TURN_CASES, and the plain version."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
    q, k, v, pools, tables, pos, dst, dense = k4aw_inputs(torch, case)

    def clones():
        return tuple(None if x is None else x.clone() for x in pools)

    fused, two, plain = clones(), clones(), clones()
    reset_all_counts()
    o = pa.paged_attention_write(q, k, v, fused[0], fused[1], tables, pos,
                                 dst, fused[2], fused[3])
    torch.cuda.synchronize()
    check(all_counts() == launch_counts(paged_attention_write=1),
          f"K4a+w {case}: launched {all_counts()}")
    store = two_launch_store(torch, k, v, two, dst)

    def two_launches():
        store()
        return pa.paged_attention(q, two[0], two[1], tables, pos, two[2],
                                  two[3])

    o2 = two_launches()
    ref = pa.paged_attention_write_reference(q, k, v, *plain[:2], tables,
                                             pos, dst, *plain[2:])
    torch.cuda.synchronize()
    live = [b for b in range(B) if b not in trash]
    err = (o[live].float() - ref[live].float()).abs().max().item()
    check(math.isfinite(err) and err <= TOL_O[dtype],
          f"paged_attention_write {case}: max |do| {err} > {TOL_O[dtype]}")
    check(torch.equal(o[live], o2[live]), f"paged_attention_write {case}: "
          f"o differs from the two-launch path's")
    keep = slice(None) if dense else slice(0, -1)
    for name, a, b, c in zip(("k", "v", "k_scale", "v_scale"), fused, two,
                             plain):
        if a is not None:
            check(torch.equal(a[keep], b[keep])
                  and torch.equal(a[keep], c[keep]),
                  f"paged_attention_write {case}: the {name} pool differs "
                  f"from the two-launch path's or the plain version's")

    def kernel():
        return pa.paged_attention_write(q, k, v, fused[0], fused[1], tables,
                                        pos, dst, fused[2], fused[3])

    exact = exactness(o, kernel(), graph_outputs(kernel, torch))
    check(exact["deterministic"] and exact["replay_exact"],
          f"paged_attention_write {case}: not the same bits run to run "
          f"{exact}")
    bound_ms, bound_by = k4aw_bound_ms(case, pos, dst)
    row = {"b": B, "w": W, "h": H, "hd": hd, "page_tokens": P,
           "pages_a_slot": n_lp, "dtype": dtype,
           "pool": "dense" if dense else pool, "contexts": list(ctx),
           "trash_slots": list(trash),
           "splits": pa.attend_splits(q, fused[0], fused[1], tables)[0],
           "max_abs_err": err, "two_launch_exact": True,
           "ms": time_ms(kernel, torch),
           "two_launch_ms": time_ms(two_launches, torch),
           "plain_ms": time_ms(lambda: pa.paged_attention_write_reference(
               q, k, v, *plain[:2], tables, pos, dst, *plain[2:]), torch,
               iters=5, repeats=5),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           **exact}
    if case in FUSED_TURN_CASES:
        # the two-launch path's store is PyTorch's index_put_ on pages of
        # q's dtype: captured in the graph as the kernels are
        turns = [(label, device_ms(fn, torch)) for label, fn in (
            ("fused", kernel), ("two", two_launches), ("two", two_launches),
            ("fused", kernel))]
        row["device_ms_turns"] = turns
        row["device_ms"] = statistics.mean(t for lb, t in turns
                                           if lb == "fused")
        row["two_launch_device_ms"] = statistics.mean(
            t for lb, t in turns if lb == "two")
        row["fused_vs_two_launch"] = (row["device_ms"]
                                      / row["two_launch_device_ms"])
    else:
        row["device_ms"] = device_ms(kernel, torch)
    row["device_vs_bound"] = row["device_ms"] / bound_ms
    emit(fused_decode_case=row)
    return row


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
            # K4a+w a layer a step (the draft's dense steps too); K4w once,
            # the prefill's insert into int8 pages, and never on decode
            want = launch_counts(
                wgmma=L + (DRAFT_LAYERS if spec else 0),
                kv_quant_write=1 if int8 else 0,
                paged_attention_write=steps * (
                    L + (SPEC_K * DRAFT_LAYERS if spec else 0)))
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
    # window (K4a+w), against the same window over bf16 pages
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
    check(got == launch_counts(paged_attention_write=L) and finite,
          f"int8 window: launched {got}, finite logits {finite}")
    emit(int8_window={"prompt_len": n, "w": SPEC_K + 1,
                      "max_abs_logit_diff_vs_bf16_pages":
                      (lq - lb).abs().max().item(),
                      "launches": dict(zip(ALL_KERNELS, got))})
    launches = all_counts()              # ... and ends here
    del pools, kv, lq, lb, draft, dmodel
    torch.cuda.empty_cache()
    return launches


def decode_profile_phase(torch, engine):
    """One torch.profiler window over 4 decode steps of one slot after a
    960-token prompt, on bf16 pages (``engine``) and on int8 pages (an
    engine with ``kv_quant``, its gate passed): the device's busy share,
    the kernels a step and the device time by kernel, K4a+w's among them
    (one launch a layer a step, K4w none)."""
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    prompt = np.random.default_rng(SEED + 7).integers(
        0, LARGE["vocab_size"], (1, PROFILE_PROMPT)).astype(np.int32)
    L = LARGE["n_layers"]
    int8 = DecodeEngine(engine.model, engine.params, max_len=engine.max_len,
                        kv_quant=True)
    for pool, eng in (("bfloat16", engine), ("int8", int8)):
        first, _l, kv, t = eng.prefill(prompt)
        state = eng.insert_slot(eng.new_state(1), kv, 0)
        check((state.arrays["k"].dtype == torch.int8) == (pool == "int8"),
              f"decode profile: a {state.arrays['k'].dtype} pool for {pool}")
        toks, pos = first, np.full((1,), t, np.int32)
        toks, _l, state = eng.decode(state, toks, pos, 1)     # warm
        torch.cuda.synchronize()

        def steps():
            nonlocal toks, pos
            for i in range(4):
                pos = pos + 1
                toks, _lg, _st = eng.decode(state, toks, pos, 2 + i)

        reset_all_counts()
        name = "decode_960_trace.json" if pool == "bfloat16" else \
            "decode_960_int8_trace.json"
        row = profile_window(torch, "decode", steps, name, top=12)
        check(all_counts() == launch_counts(paged_attention_write=4 * L),
              f"profiled decode ({pool}) launched {all_counts()}")
        traced = {k["name"]: k["count"] for k in row.get("decode_kernels",
                                                         ())}
        fused = sum(n for k, n in traced.items()
                    if "paged_attend_kernel" in k)
        quant = sum(n for k, n in traced.items() if "quant_write" in k)
        check((fused == 4 * L and quant == 0) or not TRACE_ON_DEVICE,
              f"profiled decode ({pool}) traced {fused} K4a+w and {quant} "
              f"K4w kernels, not one K4a+w a layer a step ({4 * L})")
        emit(decode_profile={"prompt_len": PROFILE_PROMPT, "steps": 4,
                             "pool": pool,
                             "kernels_per_step": row.get("kernels", 0) / 4,
                             **row})
        del state, kv
    del int8
    torch.cuda.empty_cache()


def decode_kernel_entry(kind, cases, launches):
    """The kernels-line entry of K4a ("paged_attention", its numbers at the
    decode step on bf16 pages; its int8 and dense-view cases beside them;
    since K4a+w no main path calls it alone), K4a+w
    ("paged_attention_write", the same shapes, with the two-launch path's
    times beside) or K4w ("kv_quant_write", at the bucket-1024 insert; no
    single library call computes it)."""
    group = {"paged_attention": lambda c: c[0] not in ("quant", "fused"),
             "paged_attention_write": lambda c: c[0] == "fused",
             "kv_quant_write": lambda c: c[0] == "quant"}[kind]
    key = {"paged_attention": DECODE_MAIN_CASE["paged_attention"],
           "paged_attention_write": ("fused",)
           + FUSED_MAIN_CASE["paged_attention_write"],
           "kv_quant_write": ("quant",) + QUANT_CASES[0]}[kind]
    main = cases[key]
    rows = [r for c, r in cases.items() if group(c)]
    entry = {
        "name": kind, "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}",
        "replaces": "deeplearning4j_tpu/models/transformer.py:" + {
            "paged_attention": "827", "paged_attention_write": "861",
            "kv_quant_write": "107"}[kind],
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": kind != "paged_attention",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_device_ms": main.get("library_device_ms")}
    if kind == "paged_attention":
        entry["library"] = "gather of the slot's pages + SDPA (bool mask)"
        entry["at"] = dict(zip(("b", "w", "h", "hd", "page_tokens",
                                "pages_a_slot", "dtype", "pool", "contexts",
                                "trash_slots"), DECODE_MAIN_CASE[kind]))
        for other in ("paged_attention_int8", "paged_attention_dense"):
            r = cases[DECODE_MAIN_CASE[other]]
            entry[other.split("_")[-1]] = {
                k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "library_ms", "library_device_ms")}
    elif kind == "paged_attention_write":
        entry["library"] = None
        entry["at"] = dict(zip(("b", "w", "h", "hd", "page_tokens",
                                "pages_a_slot", "dtype", "pool", "contexts",
                                "trash_slots"), FUSED_MAIN_CASE[kind]))
        entry["two_launch_device_ms"] = main["two_launch_device_ms"]
        entry["two_launch_ms"] = main["two_launch_ms"]
        for other in ("int8", "dense"):
            r = cases[("fused",) + FUSED_MAIN_CASE[other]]
            entry[other] = {k: r[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms",
                "two_launch_device_ms", "two_launch_ms")}
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


def _train_model(torch, rung, tree_cache, moe=False, base=None):
    """(model, fresh params on the card, n_params, tokens, targets) for one
    rung (batch, remat, ce_chunks) of the large config (``base``: LARGE or
    LARGE_F32): the weights of ``init_jax_layout(cfg, SEED)`` (drawn once
    per layout and kept in ``tree_cache``; f32 masters in either compute
    type), tokens from a numpy seed, targets rolled by −1."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    from deeplearning4j_tpu_torch.parallel.moe import MoEConfig
    from deeplearning4j_tpu_torch.tree import tree_leaves
    batch, remat, chunks = rung
    cfg = TransformerConfig(**(base or LARGE), remat=remat,
                            ce_chunks=chunks,
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


def train_rung(torch, fa, rung, tree_cache, moe=False, base=None,
               timed=TIMED_STEPS):
    """WARM_STEPS + ``timed`` steps of ``make_train_step(adamw(3e-4))`` at
    one rung (batch, remat, ce_chunks) of the large config (``base``) on one
    batch, each step launching exactly ``expected_per_step`` of every
    kernel. Returns (row, the launches of the steps, what a profile window
    needs)."""
    from deeplearning4j_tpu_torch.optim.adamw import adamw
    batch, remat, chunks = rung
    base = base or LARGE
    f32 = base["dtype"] == "float32"
    torch.cuda.empty_cache()
    allocated_at_start = torch.cuda.memory_allocated()
    model, params, n_params, tokens, targets = _train_model(
        torch, rung, tree_cache, moe, base)
    L, T = model.config.n_layers, model.config.max_len
    opt = adamw(LEARNING_RATE)
    state = opt.init(params)
    step = model.make_train_step(opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    losses, step_ms = [], []
    per_step = expected_per_step(L, remat, chunks, moe, f32)
    reset_all_counts()
    for i in range(WARM_STEPS + timed):          # the main path starts here
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
           "moe": moe, "dtype": base["dtype"], "seq_len": T,
           "params": n_params,
           "active_params": active_params(n_params, moe),
           "losses": losses, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": tokens_per_s, "flops_per_token": flops_per_token,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_FLOPS[base["dtype"]],
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
          and served[10:] == (0,) * 5 + ((N_NEW - 1) * LARGE["n_layers"],),
          f"MoE generate launched {served} {ALL_KERNELS}")
    emit(moe_generate={"batch": 2, "prompt_len": 100, "new_tokens": N_NEW,
                       "generate_ms": ms,
                       "launches": dict(zip(ALL_KERNELS, served))})
    del model, params, engine
    torch.cuda.empty_cache()
    return launches


def f32_serve_phase(torch):
    """The f32 model (LARGE_F32, the model's default compute type) serving
    one request through ``DecodeEngine`` in its paged mode (f32 pages): a
    PROMPT_LENS[0]-token prompt (bucket 1024) and N_NEW greedy tokens, the
    simple forward once per layer of the prefill and K4a+w once per layer of
    each decode step, no wgmma flash kernel; the decode logits held to
    ``apply`` over the same tokens (TOL_TEACHER_FORCED_F32). Returns each
    kernel's launches in the run."""
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    cfg = TransformerConfig(**LARGE_F32)
    params = from_jax_params(init_jax_layout(cfg, SEED), cfg)
    model = TransformerLM(cfg)
    engine = DecodeEngine(model, params, max_len=cfg.max_len)
    state = engine.new_state(1)
    check(engine.paged and state.arrays["k"].dtype == torch.float32,
          f"f32 engine: paged {engine.paged}, pool "
          f"{state.arrays['k'].dtype}")
    del state
    engine.warm(1)
    L, V, n = cfg.n_layers, cfg.vocab_size, PROMPT_LENS[0]
    prompt = np.random.default_rng(SEED + 8).integers(0, V, (1, n)).astype(
        np.int32)
    torch.cuda.synchronize()
    reset_all_counts()                   # the main path starts here
    t = time.perf_counter()
    toks, steps = engine.generate(prompt, N_NEW, return_logits=True)
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t)
    launches = all_counts()              # ... and ends here
    want = launch_counts(simple=L, paged_attention_write=(N_NEW - 1) * L)
    check(launches == want, f"f32 serving launched {launches}, want {want} "
          f"{ALL_KERNELS}")
    check(toks.shape == (1, N_NEW) and bool(((toks >= 0) & (toks < V))
                                            .all()), f"f32 tokens {toks}")
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.prefill(prompt)
        torch.cuda.synchronize()
        pre.append(1e3 * (time.perf_counter() - t))
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    ref = model.apply(engine.params, torch.as_tensor(
        full, device=model.device))[0, n - 1:].cpu().numpy()
    dec = np.concatenate(steps, axis=0)
    check(np.isfinite(dec).all() and np.isfinite(ref).all(),
          "f32: non-finite logits")
    diff = float(np.abs(dec - ref).max())
    prefill_ms = statistics.median(pre)
    emit(f32_request={"prompt_len": n, "bucket": engine.prefill_bucket(n),
                      "pool": "float32", "prefill_ms": prefill_ms,
                      "generate_ms": gen_ms,
                      "decode_ms_per_token": (gen_ms - prefill_ms)
                      / (N_NEW - 1),
                      "teacher_forced_max_abs_diff": diff,
                      "tolerance": TOL_TEACHER_FORCED_F32,
                      "argmax_agree": float(np.mean(
                          dec.argmax(-1) == ref.argmax(-1))),
                      "launches": dict(zip(ALL_KERNELS, launches))})
    check(diff <= TOL_TEACHER_FORCED_F32, f"f32 decode logits differ from "
          f"apply by {diff} > {TOL_TEACHER_FORCED_F32}")
    del engine, model, params
    torch.cuda.empty_cache()
    return launches


def f32_train_phase(torch, fa):
    """Training the f32 model at F32_RUNGS (WARM_STEPS + F32_TIMED_STEPS
    steps each, the launches of ``expected_per_step(..., f32=True)`` every
    step, one profiled step each); the first-step losses of the two rungs
    equal within TOL_RUNG_LOSS; one full-width gradient on the kernels
    against the plain versions at (8, no, 8) (TOL_STEP_LOSS_F32,
    TOL_STEP_LEAF_F32). Returns each kernel's launches over the steps."""
    trees, total, first = {}, [0] * len(ALL_KERNELS), {}
    for rung in F32_RUNGS:
        row, launches, (model, step, params, state, tokens, targets) = \
            train_rung(torch, fa, rung, trees, base=LARGE_F32,
                       timed=F32_TIMED_STEPS)
        total = [a + b for a, b in zip(total, launches)]
        first[rung] = row["losses"][0]
        check(abs(first[rung] - first[F32_RUNGS[0]]) <= TOL_RUNG_LOSS,
              f"f32 rung {rung}: first-step loss {first[rung]} vs "
              f"{first[F32_RUNGS[0]]}")
        train_profile_phase(torch, rung, row["ms_per_step"], step, params,
                            state, tokens, targets, "train_step_f32%s_trace"
                            ".json" % ("_ce%d" % rung[2] if rung[2] else ""),
                            f32=True)
        if rung == GRAD_RUNG:
            grad_vs_plain(torch, fa, "f32_train_vs_plain", model, params,
                          tokens, targets, TOL_STEP_LOSS_F32,
                          TOL_STEP_LEAF_F32)
        del model, step, params, state
        torch.cuda.empty_cache()
    emit(f32_rung_first_losses={str(k): v for k, v in first.items()})
    return tuple(total)


def train_profile_phase(torch, rung, step_ms, step, params, state, tokens,
                        targets, trace_name="train_step_trace.json",
                        moe=False, f32=False):
    """One torch.profiler window over one training step of ``rung`` (of
    the f32 model with ``f32``). The profiler's own host work stretches the
    window, so the device's busy time is also given over ``step_ms``, the
    median unprofiled step."""
    L = LARGE["n_layers"]
    reset_all_counts()
    row = profile_window(torch, "train_step",
                         lambda: step(params, state, tokens, targets),
                         trace_name, top=15)
    want = expected_per_step(L, rung[1], rung[2], moe, f32)
    check(all_counts() == want,
          f"profiled step launched {all_counts()}, want {want}")
    if "device_busy_us" in row:
        row["busy_over_unprofiled_step"] = (row["device_busy_us"]
                                            / (1e3 * step_ms))
    emit(train_profile={"rung": list(rung), "moe": moe,
                        "dtype": "float32" if f32 else "bfloat16", **row})


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
    # every kernel of K1 and K2 (the D pass too), and of K3 (its merge and
    # split passes too), however small
    attention = {name: tot for name, tot in by_name.items() if re.search(
        r"flash|delta_kernel|dq_kernel|dkdv_kernel", name)}
    cross_entropy = {name: tot for name, tot in by_name.items() if re.search(
        r"ce_wgmma_kernel|ce_tf32_kernel|ce_split_kernel|ce_fwd_kernel"
        r"|ce_dlogits_kernel|ce_merge_kernel", name)}
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
        "on_main_path": sum(launches.values()) > 0,
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
        "on_main_path": sum(launches.values()) > 0,
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
    """The kernels-line entry of K3f, K3b or the split pass, its numbers at
    CE_MAIN_CASE[kind]: "ce_fwd_wgmma" and "ce_dlogits_wgmma"
    (``chunked_ce_wgmma.cu``) at the bf16 training shape, "ce_fwd_tf32",
    "ce_dlogits_tf32" and "ce_split_tf32" (``chunked_ce_tf32.cu``) at the
    f32 one, and "ce_fwd" and "ce_dlogits" (``chunked_ce.cu``) from their
    forced run there. K3b's ``ms`` is one launch (one ce chunk);
    ``backward_ms`` is the whole chunked backward (the split, every chunk's
    K3b and its two products), the counterpart of ``library_ms``, the
    unchunked head's backward (a difference of two times). Each K3 entry
    also carries both designs' device times at its training shape, taken
    in turns; an f32 entry its bound at the FMA rate beside."""
    at = CE_MAIN_CASE[kind]
    main = cases[at]
    route = kind.rsplit("_", 1)[1] if kind.endswith(("_wgmma", "_tf32")) \
        else "mma_sync"
    source = f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}"
    if kind == "ce_split_tf32":
        sp = main["split"]
        return {
            "name": "chunked_ce_split_tf32", "route": "cuda",
            "source": source,
            # the f32 dots of _forward_pieces and _bwd, whose operands the
            # split pass prepares for the tensor cores
            "replaces": "deeplearning4j_tpu/kernels/chunked_ce.py:40",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "on_main_path": sum(launches.values()) > 0,
            "max_abs_err": 0.0 if all(r["split"]["exact"] for r in
                                      cases.values() if "split" in r)
            else None,
            "ms": sp["ms"], "device_ms": sp["device_ms"],
            "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
            "bound_by": sp["bound_by"], "library": None,
            "library_ms": None, "library_device_ms": None,
            "at": dict(zip(("n", "v", "d", "dtype", "ce_chunks"), at))}
    fwd = kind.startswith("ce_fwd")
    p = "fwd" if fwd else "dlogits"
    own = main if main["path"] == route else main[route]
    rows = [r for r in cases.values() if r["path"] == route] + [
        r[route] for r in cases.values() if route in r]
    entry = {
        "name": ("chunked_ce_fwd" if fwd else "chunked_ce_dlogits")
        + ("" if route == "mma_sync" else "_" + route),
        "route": "cuda", "source": source,
        "replaces": "deeplearning4j_tpu/kernels/chunked_ce.py:"
                    + ("40" if fwd else "85"),
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": sum(launches.values()) > 0,
        "max_abs_err": max(r["max_abs_err_lse" if fwd else
                             "max_abs_err_dlogits"] for r in rows),
        "ms": own[f"{p}_ms"], "device_ms": own[f"{p}_device_ms"],
        "plain_ms": main[f"{p}_plain_ms"], "bound_ms": main[f"{p}_bound_ms"],
        "bound_by": main[f"{p}_bound_by"], "library": main["library"],
        "library_ms": main["library_ms" if fwd else "library_bwd_ms"],
        "library_device_ms": main["library_device_ms" if fwd
                                  else "library_bwd_device_ms"],
        "at": dict(zip(("n", "v", "d", "dtype", "ce_chunks"), at))}
    if f"{p}_bound_fma_ms" in main:
        entry["bound_fma_ms"] = main[f"{p}_bound_fma_ms"]
    turns = main.get("turns_device_ms")
    if turns is not None:
        entry["turns_device_ms_at_training_shape"] = turns[p]
    if not fwd and own is main:
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


def check_path_launches(serve, modes, train, moe, f32_serve, f32_train):
    """Which kernels each main path launched (each an ``all_counts()``
    tuple): the bf16 paths (serving, the serving modes, the rungs, MoE)
    the wgmma flash kernels and never the simple forward or the mma.sync
    backward; the f32 paths the simple forward (serving and training) and
    the mma.sync backward (training), never a wgmma flash kernel, and
    the tf32 K3 and its split pass (training) where bf16 launches the wgmma
    K3; chunked_ce.cu's K3 on no path; K4a+w on every serving path and K4a
    on none, K4w on the int8 serving modes only (the prefill's insert)."""
    check(serve[0] > 0 and train[0] > 0 and moe[0] > 0,
          "a main path launched no flash_attention_fwd_wgmma")
    check(train[2] > 0 and moe[2] > 0,
          "training launched no flash_attention_bwd_wgmma")
    check(serve[1] == modes[1] == train[1] == moe[1] == 0,
          "a bf16 path launched the simple kernel")
    check(serve[2] == serve[3] == modes[3] == train[3] == moe[3] == 0,
          "serving launched a backward, or bf16 training the mma.sync one")
    check(f32_serve[1] > 0 and f32_train[1] > 0 and f32_train[3] > 0,
          f"the f32 paths launched no simple forward or mma.sync backward: "
          f"serve {f32_serve[:4]}, train {f32_train[:4]}")
    check(f32_serve[0] == f32_serve[2] == f32_serve[3] == 0
          and f32_train[0] == f32_train[2] == 0,
          f"an f32 path launched a wgmma flash kernel (or serving a "
          f"backward): serve {f32_serve[:4]}, train {f32_train[:4]}")
    check(all(n > 0 for n in train[8:10] + moe[6:10]),
          f"training launched no wgmma K3f or K3b, K7d or K7c: {train}, "
          f"{moe}")
    check(train[4:6] == moe[4:6] == f32_train[4:6] == (0, 0),
          f"a training path launched chunked_ce.cu's K3 kernels: bf16 "
          f"{train[4:6]}, MoE {moe[4:6]}, f32 {f32_train[4:6]}")
    check(all(n > 0 for n in f32_train[12:15])
          and f32_train[8:10] == (0, 0),
          f"f32 training launched K3 off its path: {f32_train[4:10]} "
          f"{f32_train[12:15]}")
    check(train[12:15] == moe[12:15] == (0, 0, 0),
          "bf16 training launched the tf32 K3")
    check(serve[4:10] == modes[4:10] == f32_serve[4:10] == (0,) * 6
          and serve[12:15] == modes[12:15] == f32_serve[12:15] == (0,) * 3
          and train[6:8] == f32_train[6:8] == (0, 0),
          "serving launched K3 or K7, or a dense model K7")
    k4 = [(t[10], t[11], t[15]) for t in (serve, modes, f32_serve, train,
                                          moe, f32_train)]
    check(serve[15] > 0 and modes[15] > 0 and f32_serve[15] > 0
          and serve[10] == modes[10] == f32_serve[10] == 0
          and serve[11] == f32_serve[11] == 0 and modes[11] > 0
          and k4[3:] == [(0, 0, 0)] * 3,
          f"K4a, K4w or K4a+w off their paths (serve, modes, f32 serve, "
          f"train, moe, f32 train): {k4}")


# --precision-f32: the f32 shapes of the kernel and backward phases
F32_PRECISION_CASES = [("3d", 16, 1, 256, 256, 64, "float32", True),
                       ("fused", 1, 16, 1024, 1024, 64, "float32", True),
                       ("fused", 8, 16, 1024, 1024, 64, "float32", True)]


def _attention_f64(torch, q, k, v, do, causal):
    """o, lse and (dq, dk, dv) of attention in f64 throughout: the truth
    the kernels and the plain versions are measured against."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2:]
        keep = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, vd) / l
    p = p / l
    dp = torch.matmul(dod, vd.transpose(-1, -2))
    ds = p * (dp - (dod * o).sum(-1, keepdim=True))
    return (o, (m + torch.log(l))[..., 0],
            (scale * torch.matmul(ds, kd),
             scale * torch.matmul(ds.transpose(-1, -2), qd),
             torch.matmul(p.transpose(-1, -2), dod)))


def precision_f32(torch, fa):
    """At F32_PRECISION_CASES, the f32 kernels and the plain versions each
    against f64: the forward's largest |Δo| and |Δlse|, the backward's
    largest 64-row tile relative L2 (the f32 K2 row's measure, its floor
    too), and the kernels against the plain versions, which is what the
    tolerance rows hold. The backward runs on the plain forward's o and lse
    on both sides."""
    rows = []
    for case in F32_PRECISION_CASES:
        (q, k, v, out, o, lse, do, grads,
         _sdpa) = bwd_case_inputs(torch, fa, case)
        causal, floor = case[7], GRAD_RMS_FLOOR["float32"]
        o_k = o.clone()
        o_p, lse_p = fa.flash_attention_reference(q, k, v, causal)
        o64, lse64, g64 = _attention_f64(torch, q, k, v, do, causal)
        g_k = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal,
                                     out=grads)
        g_p = fa.flash_attention_bwd_reference(q, k, v, o_p, lse_p, do,
                                               causal)
        torch.cuda.synchronize()

        def worst(gs, refs):
            return max(tile_rel_l2(g, r, floor) for g, r in zip(gs, refs))

        rows.append({
            "case": case,
            "fwd_o": {"kernel_vs_plain": (o_k - o_p).abs().max().item(),
                      "kernel_vs_f64": (o_k.double() - o64).abs().max()
                      .item(),
                      "plain_vs_f64": (o_p.double() - o64).abs().max()
                      .item()},
            "fwd_lse": {"kernel_vs_f64": (lse.double() - lse64).abs().max()
                        .item(),
                        "plain_vs_f64": (lse_p.double() - lse64).abs().max()
                        .item()},
            "bwd_tile_l2": {"kernel_vs_plain": worst(g_k, g_p),
                            "kernel_vs_f64": worst(g_k, g64),
                            "plain_vs_f64": worst(g_p, g64)}})
        emit(precision=rows[-1])
        del o64, g64, g_p
        torch.cuda.empty_cache()
    return rows


# --precision-ce-f32: the f32 training shape of K3 (bench large config,
# batch 8)
CE_PRECISION_CASE = (8192, 32768, 1024, "float32", 8)


def precision_ce_f32(torch):
    """At CE_PRECISION_CASE, K3f's lse and K3b's dlogits of the first and
    last chunk from the plain versions, chunked_ce.cu's FMA kernels and
    the tf32 kernels, each against f64: the largest |Δlse|, and K3b's two
    rows (relative L2 off the targets, largest |Δ| at them over g/N)
    against the plain version (what TOL_CE_LSE and the f32 K3b rows hold)
    and against f64. Every K3b reads
    the plain version's lse, so its readings are its products' alone. Then
    each kernel's K3f and first-chunk K3b (on parts split beforehand)
    device ms, in turns (mma_sync, tf32, tf32, mma_sync)."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    case = CE_PRECISION_CASE
    n, v, d, _dtype, chunks = case
    c = v // chunks
    x, e, t = ce_inputs(torch, case)
    lse_p, _cor = ce.chunked_ce_fwd_reference(x, e, t, chunks)
    xd = x.double()
    m64 = torch.full((n,), -math.inf, dtype=torch.float64, device="cuda")
    l64 = torch.zeros((n,), dtype=torch.float64, device="cuda")
    for i in range(chunks):
        s64 = xd @ e[i * c:(i + 1) * c].double().T
        mn = torch.maximum(m64, s64.amax(-1))
        l64 = l64 * torch.exp(m64 - mn) + torch.exp(s64 - mn[:, None]).sum(-1)
        m64 = mn
    lse64 = m64 + torch.log(l64)
    gr = torch.ones((), device="cuda")
    kernels = ["mma_sync", "tf32"]
    row = {"case": case, "lse": {
        "plain_vs_f64": (lse_p.double() - lse64).abs().max().item()}}
    for kernel in kernels:
        lse_k, _loss = ce.chunked_ce_fwd(x, e, t, chunks, kernel=kernel)
        row["lse"][f"{kernel} vs plain"] = (lse_k - lse_p).abs().max().item()
        row["lse"][f"{kernel} vs f64"] = (lse_k.double() - lse64).abs().max(
        ).item()
    del m64, l64, lse64
    for i in (0, chunks - 1):
        e_c = e[i * c:(i + 1) * c]
        ref = ce.ce_dlogits_reference(x, e_c, t, lse_p, i * c, gr, n)
        s64 = xd @ e_c.double().T
        local = torch.where((t >= i * c) & (t < (i + 1) * c), t - i * c, -1)
        onehot = torch.zeros_like(s64)
        rows = torch.nonzero(local >= 0)[:, 0]
        onehot[rows, local[rows]] = 1.0
        d64 = (torch.exp(s64 - lse_p.double()[:, None]) - onehot) / n
        del s64, onehot
        readings = {"plain vs f64": dlogits_errors(ref.double(), d64, local,
                                                   1.0 / n)}
        for kernel in kernels:
            dl = ce.ce_dlogits(x, e_c, t, lse_p, i * c, gr, n, kernel=kernel)
            readings[f"{kernel} vs plain"] = dlogits_errors(dl, ref, local,
                                                            1.0 / n)
            readings[f"{kernel} vs f64"] = dlogits_errors(dl.double(), d64,
                                                          local, 1.0 / n)
        row[f"dlogits_chunk{i}"] = {
            k: {"rel_l2_off_target": a, "at_target_over_scale": b}
            for k, (a, b) in readings.items()}
        del d64, ref, dl
        torch.cuda.empty_cache()
    parts = ce.split_tf32(x, e)
    parts0 = parts[:2] + tuple(p[:c] for p in parts[2:])
    turns = {k: {"fwd": [], "dlogits": []} for k in kernels}
    for kernel in kernels + kernels[::-1]:
        for what, fn in (
                ("fwd", lambda k: ce.chunked_ce_fwd(x, e, t, chunks,
                                                    kernel=k)),
                ("dlogits", lambda k: ce.ce_dlogits(
                    x, e[:c], t, lse_p, 0, gr, n, kernel=k,
                    parts=parts0 if k == "tf32" else None))):
            turns[kernel][what].append(device_ms(
                lambda: fn(kernel), torch, launches=5, repeats=3))
    row["turns_device_ms"] = turns
    row["tolerance"] = {"lse": TOL_CE_LSE,
                        "rel_l2_off_target": TOL_CE_DLOG_L2["float32"],
                        "at_target_over_scale":
                        TOL_CE_DLOG_TARGET["float32"]}
    emit(precision_ce=row)
    return row


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


# the cases --compare-f32 times in turns: the simple forward and the
# mma.sync / FMA backward at the f32 shapes (the table's, the f32 model's
# prefill and training layer) and bf16 at the other head dims an earlier
# tree's kernels also take
F32_COMPARE_CASES = [("3d", 16, 1, 256, 256, 64, "float32", True),
                     ("fused", 1, 16, 1024, 1024, 64, "float32", True),
                     ("fused", 8, 16, 1024, 1024, 64, "float32", True),
                     ("3d", 16, 1, 512, 512, 32, "bfloat16", True),
                     ("3d", 16, 1, 512, 512, 80, "bfloat16", True),
                     ("3d", 16, 1, 512, 512, 96, "bfloat16", True)]


# one turn of --compare-decode: the tree's own K4a and K4w at the given
# cases, then its own engine over bf16 and int8 pages after a
# PROFILE_PROMPT-token prompt, at the large config
_DECODE_TURN = """
import json, statistics, sys, time
import numpy as np, torch, chip_smoke
cases, quant = json.loads(sys.argv[1])
chip_smoke.DECODE_CASES = [tuple(tuple(x) if isinstance(x, list) else x
                                 for x in c) for c in cases]
chip_smoke.QUANT_CASES = [tuple(c) for c in quant]
chip_smoke.SPLIT_SWEEP = {}
chip_smoke.FUSED_CASES = []
chip_smoke.decode_kernel_phase(torch)
from deeplearning4j_tpu_torch.models.generation import DecodeEngine
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                     init_jax_layout)
cfg = TransformerConfig(**chip_smoke.LARGE)
params = from_jax_params(init_jax_layout(cfg, chip_smoke.SEED), cfg)
model = TransformerLM(cfg)
prompt = np.random.default_rng(chip_smoke.SEED + 7).integers(
    0, cfg.vocab_size, (1, chip_smoke.PROFILE_PROMPT)).astype(np.int32)
for quant in (False, True):
    eng = DecodeEngine(model, params, max_len=cfg.max_len, kv_quant=quant)
    first, _l, kv, t = eng.prefill(prompt)

    def ready():
        state = eng.insert_slot(eng.new_state(1), kv, 0)
        toks, pos = first, np.full((1,), t, np.int32)
        toks, _l, state = eng.decode(state, toks, pos, 1)
        torch.cuda.synchronize()
        return [state, toks, pos]

    def steps(at, n):
        state, toks, pos = at
        start = time.perf_counter()
        for i in range(n):
            pos = pos + 1
            toks, _l, state = eng.decode(state, toks, pos, 2 + i)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - start) / n

    at = ready()
    row = chip_smoke.profile_window(torch, "decode", lambda: steps(at, 4),
                                    f"turn_decode_{int(quant)}.json")
    ms = [steps(ready(), 24) for _ in range(3)]
    print(json.dumps({"decode_turn": {
        "pool": "int8" if quant else "bfloat16",
        "int8_pool": eng.kv_quant, "kernels_per_step": row["kernels"] / 4,
        "device_busy_us_per_step": row["device_busy_us"] / 4,
        "busy_share": row["busy_share"],
        "host_ms_per_step": statistics.median(ms)}}), flush=True)
    del eng, kv
"""


def compare_decode(other, this=ROOT):
    """Each tree's K4a at the decode step on bf16 and int8 pages, the dense
    view and B 8, W 5, and its K4w at the bucket-1024 insert (device ms),
    then decode at the large config over bf16 and int8 pages: kernels a
    step and device busy time a step from a profiled window of 4 steps,
    and host ms a step over 24 steps (median of 3); in the checkout at
    ``other`` and in ``this`` in turns (other, this, this, other), each
    turn a subprocess of that tree. Returns {what: {"other": [x, x],
    "this": [x, x]}}."""
    arg = json.dumps([[DECODE_CASES[i] for i in (0, 7, 11, 6)],
                      [QUANT_CASES[0]]])
    out = {}
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        run = subprocess.run([sys.executable, "-c", _DECODE_TURN, arg],
                             cwd=root, capture_output=True, text=True,
                             timeout=900)
        check(run.returncode == 0, f"decode turn in {root} failed:\n"
              f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if "decode_turn" in row:
                r = row["decode_turn"]
                key = f"decode {r['pool']}"
            elif "decode_case" in row:
                r = row["decode_case"]["device_ms"]
                key = "K4a " + " ".join(str(row["decode_case"][k]) for k in (
                    "b", "w", "page_tokens", "pool", "contexts"))
            elif "quant_write_case" in row:
                r = row["quant_write_case"]["device_ms"]
                key = "K4w " + " ".join(str(row["quant_write_case"][k])
                                        for k in ("b", "w", "layers"))
            else:
                continue
            out.setdefault(key, {}).setdefault(label, []).append(r)
    return out


def compare_turns(other, this=ROOT, fwd=None, bwd=None):
    """Device ms of K1 at ``fwd`` and K2 at ``bwd`` (by default K1 at
    MAIN_CASE["wgmma"] and the training layer, and K2 at every bf16 d
    64/128 case of BWD_CASES), in the checkout at ``other`` and in
    ``this`` in turns (other, this, this, other), each turn a subprocess of
    that tree running its own ``kernel_phase`` and ``bwd_phase``. Returns
    {"fwd"|"bwd": {case: {"other": [ms, ms], "this": [ms, ms]}}}."""
    if fwd is None:
        fwd = [MAIN_CASE["wgmma"], KERNEL_CASES[13]]
    if bwd is None:
        bwd = [c for c in BWD_CASES
               if c[6] == "bfloat16" and c[5] in (64, 128)]
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
    parser.add_argument("--compare-f32", metavar="OTHER", type=Path,
                        help="the same for the simple forward and the "
                        "mma.sync / FMA backward at F32_COMPARE_CASES")
    parser.add_argument("--compare-decode", metavar="OTHER", type=Path,
                        help="profile and time decode steps over bf16 and "
                        "int8 pages here and in the checkout at OTHER in "
                        "turns, and nothing else")
    parser.add_argument("--precision-f32", action="store_true",
                        help="measure the f32 kernels and the plain "
                        "versions against f64, and nothing else")
    parser.add_argument("--precision-ce-f32", action="store_true",
                        help="measure the f32 K3 kernels and their plain "
                        "versions against f64 at the training shape, and "
                        "nothing else")
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
    if args.compare_f32 is not None:
        emit(compare_turns=compare_turns(args.compare_f32.resolve(),
                                         fwd=F32_COMPARE_CASES,
                                         bwd=F32_COMPARE_CASES))
        return 0
    if args.compare_decode is not None:
        emit(compare_decode=compare_decode(args.compare_decode.resolve()))
        return 0
    if args.precision_f32:
        precision_f32(torch, fa)
        return 0
    if args.precision_ce_f32:
        precision_ce_f32(torch)
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
                 "chunked_ce_wgmma", "chunked_ce_tf32"):
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
    log = _build.build_logs.get("chunked_ce_tf32")
    if log is not None:
        report = ce_tf32_ptxas(log)
        emit(ce_tf32_ptxas=report)
        check(spill_free(report, CE_TF32_INSTANTIATIONS),
              f"tf32 K3: want no spills in its "
              f"{len(CE_TF32_INSTANTIATIONS)} kernels, ptxas gave {report}")
    for name, parse, want in (("flash_attention_fwd", simple_ptxas,
                               SIMPLE_INSTANTIATIONS),
                              ("flash_attention_bwd", bwd_ptxas,
                               BWD_INSTANTIATIONS)):
        log = _build.build_logs.get(name)
        if log is not None:
            report = parse(log)
            emit(**{f"{name}_ptxas": report})
            check(spill_free(report, want),
                  f"{name}: want no spills in its {len(want)} kernels, "
                  f"ptxas gave {report}")
    log = _build.build_logs.get("paged_attention")
    if log is not None:
        report = k4a_ptxas(log)
        emit(k4a_ptxas=report)
        check(spill_free(report, K4A_INSTANTIATIONS),
              f"K4a: want no spills in its {len(K4A_INSTANTIATIONS)} "
              f"instantiations, ptxas gave {report}")
        report = k4w_ptxas(log)
        emit(k4w_ptxas=report)
        check(spill_free(report, K4W_INSTANTIATIONS),
              f"K4w: want no spills in its {len(K4W_INSTANTIATIONS)} "
              f"instantiations, ptxas gave {report}")
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_build._target("paged_attention"))], capture_output=True,
            text=True, check=True, timeout=300).stdout
        loads = k4a_readonly_loads(sass)
        emit(k4a_readonly_loads=sum(loads.values()), functions=len(loads))
        check(len(loads) == len(K4A_INSTANTIATIONS)
              and not any(loads.values()),
              f"K4a: pool loads through the read-only path {loads}")

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
    allocated("moe_train_phase")
    f32_serve = f32_serve_phase(torch)
    f32_train = f32_train_phase(torch, fa)
    launches = {name: {"serve": serve[i], "serve_modes": modes[i],
                       "train": train[i], "moe": moe[i],
                       "f32_serve": f32_serve[i], "f32_train": f32_train[i]}
                for i, name in enumerate(ALL_KERNELS)}
    emit(main_path_launches=launches)
    check_path_launches(serve, modes, train, moe, f32_serve, f32_train)
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
                                      launches["kv_quant_write"])]
         + [ce_kernel_entry(k, ce_cases, launches[k])
            for k in ("ce_fwd_tf32", "ce_dlogits_tf32", "ce_split_tf32")]
         + [decode_kernel_entry("paged_attention_write", decode_cases,
                                launches["paged_attention_write"])])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
