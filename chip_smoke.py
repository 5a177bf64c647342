#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``kernels/csrc/`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card
at the main path's shapes (and times kernel, plain version, the PyTorch
library call and the card's bound), then serves generation from
``TransformerLM`` at the full width of the bench's large config
(vocab 32768, 12 layers, 16 heads, d_model 1024, d_ff 4096, max_len 1024,
bf16, fused QKV; random weights from a numpy seed through
``from_jax_params``) through ``DecodeEngine`` in its default paged mode,
and checks the tokens and logits. Every phase must pass: any failure
exits nonzero. Output is one JSON object per line; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout,
it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_NEW = 32
PROMPT_LENS = (960, 500, 200, 37)       # buckets 1024, 512, 256, 64
# (BH, T, d, dtype, causal): the prefill shapes of the large config
# (B·16 heads, d 64, buckets up to 1024), a larger batch, a ragged T,
# non-causal, f32 and d = 128
KERNEL_CASES = [
    (16, 64, 64, "bfloat16", True), (16, 256, 64, "bfloat16", True),
    (16, 512, 64, "bfloat16", True), (16, 1024, 64, "bfloat16", True),
    (64, 512, 64, "bfloat16", True), (16, 1000, 64, "bfloat16", True),
    (16, 1024, 64, "bfloat16", False), (16, 256, 64, "float32", True),
    (16, 512, 128, "bfloat16", True)]
MAIN_CASE = (16, 1024, 64, "bfloat16", True)
# the bench's large config (bench.py, the "large" rung)
LARGE = dict(vocab_size=32768, n_layers=12, n_heads=16, d_model=1024,
             d_ff=4096, max_len=1024, dtype="bfloat16", fused_qkv=True)
# tolerances (PERF.md states the reasons): kernel vs plain version on the
# same inputs, and decode logits vs the full forward over the same tokens
TOL_O = {"bfloat16": 2e-2, "float32": 5e-5}
TOL_LSE = 1e-3
TOL_TEACHER_FORCED = 0.1
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA
# (no TF32 in the port), device memory bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def emit(**kv):
    print(json.dumps(kv), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, torch, iters=20, repeats=7):
    """Median over ``repeats`` of CUDA-event time per call of ``fn``."""
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


def attention_bound_ms(bh, t, d, dtype, causal):
    """Least time for one call: the larger of its FLOPs over the peak
    rate of its type and its bytes (q, k, v read once, o and lse written
    once) over the memory rate. Causal counts only the kept pairs."""
    itemsize = 2 if dtype == "bfloat16" else 4
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * bh * d * pairs
    nbytes = itemsize * bh * t * d * 4 + 4 * bh * t
    t_ops, t_mem = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def kernel_phase(torch, fa):
    """flash_attention_fwd against its plain version at each case."""
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
        bh, t, d, dtype, causal = case
        g = torch.Generator(device="cuda").manual_seed(bh * 100003 + t + d)
        q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda",
                               dtype=getattr(torch, dtype))
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err_o) and err_o <= TOL_O[dtype],
              f"flash_attention_fwd {case}: max |do| {err_o} > "
              f"{TOL_O[dtype]}")
        check(math.isfinite(err_lse) and err_lse <= TOL_LSE,
              f"flash_attention_fwd {case}: max |dlse| {err_lse} > "
              f"{TOL_LSE}")
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), torch)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal), torch,
            iters=5, repeats=5)
        q4, k4, v4 = q[None], k[None], v[None]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), torch)
        bound_ms, bound_by = attention_bound_ms(bh, t, d, dtype, causal)
        row = {"bh": bh, "t": t, "d": d, "dtype": dtype, "causal": causal,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(kernel_case=row)
        results[case] = row
    return results


def slice_phase(torch, fa):
    """Full-width generation through the port's entry points."""
    from deeplearning4j_tpu_torch.models.generation import (DecodeEngine,
                                                            SamplerConfig)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)

    cfg = TransformerConfig(**LARGE)
    t0 = time.perf_counter()
    params = from_jax_params(init_jax_layout(cfg, SEED), cfg)
    model = TransformerLM(cfg)
    engine = DecodeEngine(model, params, max_len=1024)
    check(engine.paged and engine.page_tokens == 64,
          f"engine is not in its default paged mode ({engine.page_tokens})")
    engine.warm(1)
    torch.cuda.synchronize()
    emit(setup={"params": sum(p.numel() for p in _leaves(params)),
                "seconds": time.perf_counter() - t0,
                "page_tokens": engine.page_tokens})
    L, V = cfg.n_layers, cfg.vocab_size
    rng = np.random.default_rng(SEED + 1)

    def launched(fn):
        before = fa.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, fa.launches - before, 1e3 * (time.perf_counter() - t)

    def tokens_ok(toks, shape):
        check(toks.shape == shape, f"tokens shape {toks.shape} != {shape}")
        check(bool(((toks >= 0) & (toks < V)).all()), "token out of range")

    fa.launches = 0                      # the main path's run starts here
    for n in PROMPT_LENS:
        prompt = rng.integers(0, V, (1, n)).astype(np.int32)
        bucket = engine.prefill_bucket(n)
        (toks, steps), got, _ms = launched(
            lambda: engine.generate(prompt, N_NEW, return_logits=True))
        check(got == L, f"prompt {n}: {got} kernel launches, want {L}")
        tokens_ok(toks, (1, N_NEW))
        pre = []
        for _ in range(3):
            _out, got, ms = launched(lambda: engine.prefill(prompt))
            check(got == L, f"prefill {n}: {got} launches, want {L}")
            pre.append(ms)
        toks2, got, gen_ms = launched(lambda: engine.generate(prompt, N_NEW))
        check(got == L and np.array_equal(toks2, toks),
              f"prompt {n}: greedy rerun differs or launched {got}")
        # teacher forcing: the full forward (kernel path) over prompt +
        # generated tokens against each step's logits (prefill, then the
        # plain-torch paged decode)
        full = np.concatenate([prompt, toks[:, :-1]], axis=1)
        ref, got, _ms = launched(lambda: model.apply(
            engine.params, torch.as_tensor(full, device=model.device)))
        check(got == L, f"apply {n}: {got} launches, want {L}")
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
    check(got == L, f"batch: {got} launches, want {L}")
    tokens_ok(toks, (4, N_NEW))
    emit(batch={"batch": 4, "prompt_len": 100, "generate_ms": ms})

    topk = DecodeEngine(model, engine.params, max_len=1024, seed=7,
                        sampler=SamplerConfig("topk", top_k=40,
                                              temperature=0.8))
    prompt = rng.integers(0, V, (1, 300)).astype(np.int32)
    runs = []
    for _ in range(2):
        toks, got, ms = launched(lambda: topk.generate(prompt, N_NEW))
        check(got == L, f"top-k: {got} launches, want {L}")
        tokens_ok(toks, (1, N_NEW))
        runs.append(toks)
    check(np.array_equal(runs[0], runs[1]), "top-k runs differ")
    emit(topk={"top_k": 40, "temperature": 0.8, "seed": 7,
               "identical": True, "generate_ms": ms})
    return fa.launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
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

    t0 = time.perf_counter()
    compiled = _build.build_all()
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit(build={"seconds": time.perf_counter() - t0, "compiled": compiled,
                "ptxas": ptxas})

    cases = kernel_phase(torch, fa)
    launches = slice_phase(torch, fa)
    main_case = cases[MAIN_CASE]
    emit(kernels=[{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:41",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err_o"] for r in cases.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}])
    check(launches > 0, "the main path launched no flash_attention_fwd")
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
