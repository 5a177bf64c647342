"""CPU rehearsal of the f32 flash attention's precision, before the card.

Prints one JSON object a line: the largest relative L2 error of a 64-row
tile (its norm floored at an rms of 1e-6, as the f32 K2 row floors it) of
each gradient, and the forward's largest |Δo|, for f32 attention computed
several ways from the same numpy inputs:

- ``f64``: every product and elementwise step in f64 (the truth);
- ``plain``: :func:`flash_attention_bwd_reference` in f32 (PyTorch on the
  CPU);
- ``exact``: f32 operands, each product exact in f64 and rounded once;
- ``split3`` / ``split4``: the three-product TF32 split
  (:func:`split_matmul`), and with the fourth product small·small;
- a model of the card: the plain version as sequential f32 FMA over the
  reduction (as cuBLAS's f32 GEMMs sum), against kernels whose products
  take 8-term chunks, each summed exactly and added to the f32 accumulator
  with one rounding (``mma3``, ``mma4``), or that keep sequential FMA for
  S and dP (``fma_s_dp``);
- the chunked cross-entropy's product at d 1024 (``ce_card_model``): the
  tf32 K3b's logits x·E_cᵀ with each of the three split products an
  instruction of its own over 8-deep steps, the accumulator rounded after
  each to nearest (``rn``) or toward zero (``rz``: the tensor cores' f32
  sums truncate), or with the sums promoted (``promoted``: each 32-deep
  panel's products truncated into a zeroed partial sum, added to the f32
  accumulator to nearest); the dlogits ``exp(s − lse)`` of each way against
  the plain version's (sequential FMA) and f64's, by the K3b row's measure
  (relative L2 off the targets). ``rz`` also models the f32 flash forward
  (``flash_rz``), whose split o PERF.md §6 reads on the card.

Run from the root of the checkout: ``python -m tools.f32_rehearsal``.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import flash_attention as fa


def tile_l2(x, ref, floor=1e-6, rows=64) -> float:
    worst = 0.0
    for i in range(0, x.shape[-2], rows):
        a = np.asarray(x[i:i + rows], np.float64)
        b = np.asarray(ref[i:i + rows], np.float64)
        den = max(np.linalg.norm(b), floor * math.sqrt(b.size))
        worst = max(worst, float(np.linalg.norm(a - b) / den))
    return worst


def _split_terms(a, b, four):
    (ab, as_), (bb, bs) = fa.tf32_split(a), fa.tf32_split(b)
    a64, b64 = ab.astype(np.float64), bb.astype(np.float64)
    out = (a64 @ b64 + a64 @ bs.astype(np.float64)
           + as_.astype(np.float64) @ b64)
    if four:
        out = out + as_.astype(np.float64) @ bs.astype(np.float64)
    return out


def mm_exact(a, b):
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def mm_split(four):
    return lambda a, b: _split_terms(a, b, four).astype(np.float32)


def mm_fma(a, b):
    """Sequential f32 FMA over k: each step rounds acc + a b once."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64) + np.outer(a64[:, k], b64[k])).astype(
            np.float32)
    return acc


def mm_mma(four, chunk=8):
    """8-term chunks of the split products, each added to an f32
    accumulator with one rounding."""
    def mm(a, b):
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k0 in range(0, a.shape[1], chunk):
            c = _split_terms(a[:, k0:k0 + chunk], b[k0:k0 + chunk], four)
            acc = (acc.astype(np.float64) + c).astype(np.float32)
        return acc
    return mm


def _rz(val):
    """f64 values rounded toward zero to f32."""
    r = val.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(val)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def mm_tc(mode, chunk=8, panel=32):
    """The split products as a tensor core takes them: per 8-deep step
    three instructions (small·big, big·small, big·big), each adding its 8
    exact products to the f32 accumulator with one rounding, to nearest
    (``rn``) or toward zero (``rz``); ``promoted``: the ``rz`` sums of each
    ``panel``-deep panel in a zeroed partial sum, added to the accumulator
    to nearest."""
    def mm(a, b):
        (ab, as_), (bb, bs) = fa.tf32_split(a), fa.tf32_split(b)
        terms = [(x.astype(np.float64), y.astype(np.float64))
                 for x, y in ((as_, bb), (ab, bs), (ab, bb))]
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for p0 in range(0, a.shape[1], panel):
            part = (np.zeros_like(acc) if mode == "promoted" else acc)
            for k0 in range(p0, min(p0 + panel, a.shape[1]), chunk):
                for x, y in terms:
                    val = (part.astype(np.float64)
                           + x[:, k0:k0 + chunk] @ y[k0:k0 + chunk])
                    part = (val.astype(np.float32) if mode == "rn"
                            else _rz(val))
            acc = ((acc.astype(np.float64) + part).astype(np.float32)
                   if mode == "promoted" else part)
        return acc
    return mm


def ce_card_model(n=32, c=4096, d=1024):
    """One K3b chunk at the training layer's d and scales (x ~ N(0, 1),
    E ~ 0.02 N(0, 1), chip_smoke's ce_inputs), ``n`` rows: each way's
    dlogits relative L2 against the plain version's and f64's, and its
    largest |Δlogit| against f64; the flash forward's o (T 256, d 64)
    under the ``rz`` model against f64."""
    rng = np.random.default_rng(n + c + d)
    x = rng.standard_normal((n, d), dtype=np.float32)
    e = (0.02 * rng.standard_normal((c, d))).astype(np.float32)
    s64 = x.astype(np.float64) @ e.astype(np.float64).T
    plain = mm_fma(x, e.T)
    lse = np.log(np.exp(plain.astype(np.float64)).sum(-1))[:, None]

    def rel(s, ref):
        p, q = np.exp(s.astype(np.float64) - lse), np.exp(ref - lse)
        return float(np.linalg.norm(p - q) / np.linalg.norm(q))

    res = {"plain": {"vs_f64": rel(plain, s64),
                     "max_dlogit_vs_f64": float(np.abs(plain - s64).max())}}
    for mode in ("rn", "rz", "promoted"):
        got = mm_tc(mode)(x, e.T)
        res[mode] = {"vs_plain": rel(got, plain.astype(np.float64)),
                     "vs_f64": rel(got, s64),
                     "max_dlogit_vs_f64": float(np.abs(got - s64).max())}
    q, k, v = (rng.standard_normal((256, 64), dtype=np.float32)
               for _ in range(3))
    o64, _ = forward(*(t.astype(np.float64) for t in (q, k, v)), True,
                     lambda a, b: a @ b)
    o_rz, _ = forward(q, k, v, True, mm_tc("rz"))
    res["flash_rz_o_vs_f64"] = float(np.abs(o_rz - o64).max())
    return {"case": [n, c, d], "ce_card_model": res}


def forward(q, k, v, causal, mm):
    scale = np.float32(1 / math.sqrt(q.shape[-1]))
    s = mm(q, k.T) * scale
    if causal:
        s = np.where(np.tri(*s.shape, dtype=bool), s, np.float32(-1e30))
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = np.maximum(p.sum(-1, keepdims=True), np.float32(1e-30))
    return mm(p, v) / l, (m + np.log(l))[:, 0]


def backward(q, k, v, o, lse, do, causal, mms):
    """dq, dk, dv with each product by ``mms[name]`` (s, dp, dv, dq, dk),
    the elementwise steps in the inputs' dtype."""
    scale = q.dtype.type(1 / math.sqrt(q.shape[-1]))
    delta = (do * o).sum(-1, keepdims=True)
    s = mms["s"](q, k.T) * scale
    if causal:
        s = np.where(np.tri(*s.shape, dtype=bool), s, q.dtype.type(-1e30))
    p = np.exp(s - lse[:, None])
    dv = mms["dv"](p.T, do)
    ds = p * (mms["dp"](do, v.T) - delta)
    return scale * mms["dq"](ds, k), scale * mms["dk"](ds.T, q), dv


def _all(mm):
    return dict.fromkeys(("s", "dp", "dv", "dq", "dk"), mm)


def against_f64(tq=256, d=64, causal=True):
    """One head: each way's o (largest |Δ|) and gradients against f64
    everywhere."""
    rng = np.random.default_rng(tq + d)
    q, k, v, do = (rng.standard_normal((tq, d), dtype=np.float32)
                   for _ in range(4))
    o, lse = fa.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal)
    o, lse = o.numpy(), lse.numpy()
    o64, _ = forward(*(x.astype(np.float64) for x in (q, k, v)), causal,
                     lambda a, b: a @ b)
    fwd_o = {way: float(np.abs(got - o64).max()) for way, got in (
        ("plain", o),
        ("split3", fa.flash_attention_split_emulation(q, k, v, causal)[0]))}
    plain = [g.numpy() for g in fa.flash_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v, o, lse, do)), causal)]
    truth = backward(*(x.astype(np.float64) for x in (q, k, v, o, lse, do)),
                     causal, _all(lambda a, b: a @ b))
    ways = {"plain": plain,
            "exact": backward(q, k, v, o, lse, do, causal, _all(mm_exact)),
            "split3": backward(q, k, v, o, lse, do, causal,
                               _all(mm_split(False)))}
    return {"case": [tq, d, causal], "fwd_o_vs_f64": fwd_o, "vs_f64": {
        way: {n: tile_l2(g, t) for n, g, t in zip(("dq", "dk", "dv"), gs,
                                                    truth)}
        for way, gs in ways.items()}}


def against_plain(tq, d, causal, heads=4):
    """The largest tile L2 over ``heads`` heads of each way against the
    plain version (PyTorch f32 on the CPU)."""
    rng = np.random.default_rng(tq + d)
    worst = {}
    for _ in range(heads):
        q, k, v, do = (rng.standard_normal((tq, d), dtype=np.float32)
                       for _ in range(4))
        o, lse = fa.flash_attention_reference(
            *map(torch.from_numpy, (q, k, v)), causal)
        o, lse = o.numpy(), lse.numpy()
        plain = [g.numpy() for g in fa.flash_attention_bwd_reference(
            *map(torch.from_numpy, (q, k, v, o, lse, do)), causal)]
        for way, mm in (("exact", mm_exact), ("split3", mm_split(False)),
                        ("split4", mm_split(True))):
            got = backward(q, k, v, o, lse, do, causal, _all(mm))
            worst[way] = max(worst.get(way, 0.0),
                             max(tile_l2(a, b) for a, b in zip(got, plain)))
    return {"case": [tq, d, causal], "heads": heads, "vs_plain": worst}


def card_model(tq, d, causal, heads=2):
    """The model of the card: sequential-FMA plain version against chunked
    tensor-core kernels; the forward's largest |Δo| and |Δlse|, and each
    backward variant's largest tile L2 over ``heads`` heads."""
    variants = {"mma3": _all(mm_mma(False)), "mma4": _all(mm_mma(True)),
                "fma_s_dp": dict(s=mm_fma, dp=mm_fma, dv=mm_mma(False),
                                 dq=mm_mma(False), dk=mm_mma(False))}
    rng = np.random.default_rng(tq + d)
    res = {}
    for _ in range(heads):
        q, k, v, do = (rng.standard_normal((tq, d), dtype=np.float32)
                       for _ in range(4))
        o_p, lse_p = forward(q, k, v, causal, mm_fma)
        o_k, lse_k = forward(q, k, v, causal, mm_mma(False))
        res["fwd_o"] = max(res.get("fwd_o", 0.0),
                           float(np.abs(o_k - o_p).max()))
        res["fwd_lse"] = max(res.get("fwd_lse", 0.0),
                             float(np.abs(lse_k - lse_p).max()))
        plain = backward(q, k, v, o_p, lse_p, do, causal, _all(mm_fma))
        for name, mms in variants.items():
            got = backward(q, k, v, o_p, lse_p, do, causal, mms)
            for n, a, b in zip(("dq", "dk", "dv"), got, plain):
                key = f"{name}:{n}"
                res[key] = max(res.get(key, 0.0), tile_l2(a, b))
    return {"case": [tq, d, causal], "heads": heads, "card_model": res}


def main() -> None:
    print(json.dumps(against_f64()), flush=True)
    print(json.dumps(against_f64(1024)), flush=True)
    for tq, d in ((256, 64), (1024, 64), (200, 256)):
        print(json.dumps(against_plain(tq, d, True)), flush=True)
    for tq, d, causal in ((256, 64, True), (1024, 64, True),
                          (130, 48, False)):
        print(json.dumps(card_model(tq, d, causal)), flush=True)
    print(json.dumps(ce_card_model()), flush=True)


if __name__ == "__main__":
    main()
