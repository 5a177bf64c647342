"""The CPU-side arithmetic of ``chip_smoke.py``.

It runs on the card; what it computes from shapes and text (the bound it
holds each kernel to, the profiler's busy share, the ptxas report it
checks the wgmma kernel's build against) is checked here.
"""
import json

import numpy as np
import pytest

import chip_smoke


def test_bound_at_the_main_shape_is_pr1s():
    ms, by = chip_smoke.attention_bound_ms(16, 1024, 1024, 64, "bfloat16",
                                           True)
    assert by == "bytes" and ms == pytest.approx(0.0025236250746268657)


def test_bound_counts_only_kept_causal_pairs():
    # Tq 3, Tk 2: rows keep 1, 2, 2 keys
    flops_ms, _ = chip_smoke.attention_bound_ms(1, 3, 2, 64, "float32", True)
    ops = 4.0 * 64 * (1 + 2 + 2) / chip_smoke.ATTN_PEAK_FLOPS["float32"]
    nbytes = 4 * 64 * 2 * (3 + 2) + 4 * 3
    assert flops_ms == pytest.approx(1e3 * max(ops, nbytes /
                                               chip_smoke.PEAK_BYTES))
    full_ms, by = chip_smoke.attention_bound_ms(16, 512, 1024, 64,
                                                "bfloat16", False)
    assert by == "operations"
    assert full_ms == pytest.approx(
        1e3 * 4.0 * 16 * 64 * 512 * 1024 / chip_smoke.PEAK_FLOPS["bfloat16"])


def test_bwd_bound_at_the_training_shape():
    """B 8 × H 16, T 1024, d 64, bf16, causal: 10·d FLOPs per kept pair
    (five products) = 43.0 GFLOP against 134.7 MB (q, k, v, o, dO, dq,
    dk, dv and lse), so the tensor cores bound it."""
    ms, by = chip_smoke.attention_bwd_bound_ms(128, 1024, 1024, 64,
                                               "bfloat16", True)
    flops = 10.0 * 128 * 64 * (1024 * 1025 // 2)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flops / 989e12)
    assert ms == pytest.approx(0.04347, rel=1e-3)


def test_bwd_bound_counts_eight_tensors_and_lse():
    # Tq 3, Tk 2, non-causal, f32: memory bounds a tiny call
    ms, by = chip_smoke.attention_bwd_bound_ms(2, 3, 2, 16, "float32", False)
    nbytes = 4 * 2 * 16 * 4 * (3 + 2) + 4 * 2 * 3
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / chip_smoke.PEAK_BYTES)
    causal_ms, by = chip_smoke.attention_bwd_bound_ms(
        16, 2048, 4096, 64, "bfloat16", True)
    # causal rows of Tq 2048 over Tk 4096 keep 1..2048 keys
    assert by == "operations"
    assert causal_ms == pytest.approx(
        1e3 * 10.0 * 16 * 64 * (2048 * 2049 // 2) / 989e12)


def test_train_flops_per_token_is_bench_s_count():
    # 6·N + 6·L·T·d: at the bench's large config (185,710,592 params, 12
    # layers, T 1024, d 1024) 1.19 GFLOP a token
    assert chip_smoke.train_flops_per_token(100, 2, 8, 4) == 600 + 6 * 64
    assert chip_smoke.train_flops_per_token(185_710_592, 12, 1024, 1024) \
        == 1_189_761_024


def test_tile_rel_l2_sees_a_wrong_tail_tile():
    """A gradient wrong only on its last (ragged) 64-row tile along T fails
    the tile check at full weight, though its largest entries are right."""
    import torch
    g = torch.Generator().manual_seed(0)
    ref = torch.randn((2, 4, 130, 16), generator=g)
    ref[..., :64, :] *= 100.0            # large first rows, as at causal key 0
    assert chip_smoke.tile_rel_l2(ref, ref, 1e-3) == 0.0
    bad = ref.clone()
    bad[..., 128:, :] *= 1.1
    assert chip_smoke.tile_rel_l2(bad, ref, 1e-3) == pytest.approx(0.1,
                                                                   rel=1e-5)
    whole = ((bad - ref).norm() / ref.norm()).item()
    assert whole < 1e-3                  # a whole-tensor norm hides it
    # the (B, H, T, d) view of a (B, T, H, d) buffer is split along T too
    view = bad.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    assert chip_smoke.tile_rel_l2(view, ref, 1e-3) == pytest.approx(
        0.1, rel=1e-5)


def test_tile_rel_l2_floors_a_tile_that_cancels_to_zero():
    import torch
    ref = torch.zeros((1, 1, 64))
    x = torch.full((1, 1, 64), 3e-7)
    # the error over an rms floor of 1e-3: 3e-7 / 1e-3
    assert chip_smoke.tile_rel_l2(x, ref, 1e-3) == pytest.approx(3e-4)


def test_plain_attention_swaps_the_kernels_out_and_back():
    import torch

    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    kernels = fa.flash_attention_fwd, fa.flash_attention_bwd
    x = torch.randn((2, 9, 3 * 32), generator=torch.Generator()
                    .manual_seed(0)).requires_grad_()
    o = fa.FlashAttention.apply(2, True, 0.25, x)
    (want,) = torch.autograd.grad(o.square().sum(), x)
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.plain_attention(fa):
            assert (fa.flash_attention_fwd, fa.flash_attention_bwd) != \
                kernels
            o = fa.FlashAttention.apply(2, True, 0.25, x)
            (got,) = torch.autograd.grad(o.square().sum(), x)
            raise RuntimeError("inside")
    assert (fa.flash_attention_fwd, fa.flash_attention_bwd) == kernels
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([(0, 5), (3, 8), (10, 12), (11, 20)], 1, 15, 12.0),
    ([(2, 3), (2, 3)], 0, 10, 1.0),
    ([(5, 9)], 6, 7, 1.0),
    ([], 0, 10, 0.0),
])
def test_busy_time_is_the_union_inside_the_window(intervals, lo, hi, want):
    assert chip_smoke._union_us(intervals, lo, hi) == want


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_iii7OutArgsiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_iii7OutArgsiiifi
    0 bytes stack frame, {s128} bytes spill stores, {l128} bytes spill loads
ptxas info    : Used {r128} registers, used 16 barriers, 616 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_iii7OutArgsiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_iii7OutArgsiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 616 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15other_kerneli' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers
"""


@pytest.mark.parametrize("r128,s128,l128,want_ok", [
    (168, 0, 0, True),
    (168, 24, 24, False),      # d 128 spills
    (160, 0, 0, False),        # not the budget setmaxnreg 24 / 240 needs
])
def test_ptxas_report_of_each_wgmma_instantiation(r128, s128, l128,
                                                  want_ok):
    report = chip_smoke.wgmma_ptxas(_PTXAS.format(r128=r128, s128=s128,
                                                  l128=l128))
    # the other kernel's lines are not the wgmma kernel's
    assert report == {128: {"registers": r128, "spill_bytes": s128 + l128},
                      64: {"registers": 168, "spill_bytes": 0}}
    ok = all(r["registers"] == chip_smoke.WGMMA_ENTRY_REGISTERS
             and r["spill_bytes"] == 0 for r in report.values())
    assert ok == want_ok


def test_profile_phase_fails_on_the_card_without_device_events(
        tmp_path, monkeypatch):
    """An empty trace is a failure unless the phase is rehearsed on the
    CPU (TRACE_ON_DEVICE False), where 'not measured' is the answer."""
    import torch

    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    class Engine:
        def prefill(self, prompt):
            fa.launches_wgmma += chip_smoke.LARGE["n_layers"]

    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(AssertionError, match="not measured"):
        chip_smoke.profile_phase(torch, fa, Engine())
    monkeypatch.setattr(chip_smoke, "TRACE_ON_DEVICE", False)
    chip_smoke.profile_phase(torch, fa, Engine())


_BWD_PTXAS = """\
ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__e2d26d69_28_flash_attention_bwd_wgmma_cu_c40b2a6a22flash_bwd_wgmma_kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_S1_iiiiNS_7BwdArgsE' for 'sm_90a'
    0 bytes stack frame, {s} bytes spill stores, {s} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__e2d26d69_28_flash_attention_bwd_wgmma_cu_c40b2a6a22flash_bwd_wgmma_kernelILi128ELb0EEEv14CUtensorMap_stS1_S1_S1_iiiiNS_7BwdArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__e2d26d69_28_flash_attention_bwd_wgmma_cu_c40b2a6a22flash_bwd_wgmma_kernelILi64ELb1EEEv14CUtensorMap_stS1_S1_S1_iiiiNS_7BwdArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__e2d26d69_28_flash_attention_bwd_wgmma_cu_c40b2a6a22flash_bwd_wgmma_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_S1_iiiiNS_7BwdArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN61_GLOBAL__N__e2d26d69_28_flash_attention_bwd_wgmma_cu_c40b2a6a12delta_kernelI13__nv_bfloat16EEvNS_9DeltaArgsE' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 36 registers, used 0 barriers
"""


@pytest.mark.parametrize("spill", [0, 40])
def test_ptxas_report_of_each_bwd_wgmma_kernel(spill):
    """Each of the wgmma backward's four kernels (dQ and dK/dV at d 64 and
    128) by its registers and spills; the D pass's lines are not theirs."""
    report = chip_smoke.bwd_wgmma_ptxas(_BWD_PTXAS.format(s=spill))
    assert report == {
        "d128 dkdv": {"registers": 168, "spill_bytes": 2 * spill},
        "d128 dq": {"registers": 168, "spill_bytes": 0},
        "d64 dkdv": {"registers": 168, "spill_bytes": 0},
        "d64 dq": {"registers": 160, "spill_bytes": 0}}
    # the wgmma forward's parser sees none of them
    assert chip_smoke.wgmma_ptxas(_BWD_PTXAS.format(s=spill)) == {}


_CE_PTXAS = """\
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__4c1d2e77_19_chunked_ce_wgmma_cu_0b9a4f1315ce_merge_kernelEPKfiiPfS2_' for 'sm_90a'
    0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__4c1d2e77_19_chunked_ce_wgmma_cu_0b9a4f1315ce_wgmma_kernelILb1EEEv14CUtensorMap_stS1_S1_NS_4ArgsE' for 'sm_90a'
    0 bytes stack frame, {s} bytes spill stores, {s} bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__4c1d2e77_19_chunked_ce_wgmma_cu_0b9a4f1315ce_wgmma_kernelILb0EEEv14CUtensorMap_stS1_S1_NS_4ArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


@pytest.mark.parametrize("spill", [0, 24])
def test_ptxas_report_of_each_ce_wgmma_kernel(spill):
    """The wgmma K3's two instantiations (K3f and K3b) by registers and
    spills; the merge kernel's spills are not theirs, the flash parsers
    see none of them, and a serialization warning is found beside them."""
    log = _CE_PTXAS.format(s=spill)
    assert chip_smoke.ce_wgmma_ptxas(log) == {
        "dlogits": {"registers": 168, "spill_bytes": 2 * spill},
        "fwd": {"registers": 168, "spill_bytes": 0}}
    assert chip_smoke.wgmma_ptxas(log) == {}
    assert chip_smoke.bwd_wgmma_ptxas(log) == {}
    assert chip_smoke.ce_wgmma_ptxas(_BWD_PTXAS.format(s=0)) == {}
    assert chip_smoke.serialized_wgmma(log) == []
    warned = log + ("ptxas warning : (C7514) Potential Performance Loss: "
                    "wgmma.mma_async instructions are serialized due to "
                    "...\n"
                    "ptxas warning : (C7512) Potential Performance Loss: "
                    "wgmma.mma_async instructions are serialized ...\n")
    assert len(chip_smoke.serialized_wgmma(warned)) == 2


def _bwd_row(path, case, device_ms, err):
    names = ("layout", "b", "h", "t_q", "t_k", "d", "dtype", "causal")
    row = dict(zip(names, case), path=path, device_ms=device_ms,
               max_abs_err={"dq": err, "dk": err / 2, "dv": 0.0})
    for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms", "library_bwd_device_ms", "fwd_bwd_ms",
                "fwd_bwd_device_ms"):
        row[key] = device_ms + len(key)
    row["bound_by"] = "operations"
    return row


def test_kernels_line_has_an_entry_for_each_backward():
    """Both K2 kernels get a kernels-line entry with every key the line
    needs, each from its own path's cases and main case, and only the
    wgmma one is on the main path."""
    cases = {c: _bwd_row("bwd_wgmma" if c[6] == "bfloat16" and c[5] in
                         (64, 128) else "bwd", c, 0.1 * i, 1e-3 * (i + 1))
             for i, c in enumerate(chip_smoke.BWD_CASES)}
    launches = {"serve": 0, "train": 84}
    new = chip_smoke.bwd_kernel_entry("bwd_wgmma", cases, launches)
    old = chip_smoke.bwd_kernel_entry("bwd", cases,
                                      {"serve": 0, "train": 0})
    for entry in (new, old):
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_bwd_device_ms"):
            assert key in entry
        assert entry["route"] == "cuda"
        assert entry["replaces"].endswith("flash_attention.py:153")
    assert new["name"] == "flash_attention_bwd_wgmma"
    assert new["source"].endswith("csrc/flash_attention_bwd_wgmma.cu")
    assert (new["launches"], new["on_main_path"]) == (84, True)
    assert new["device_ms"] == cases[chip_smoke.BWD_CASES[0]]["device_ms"]
    # bf16 d 64/128 cases are 0-6: the largest error among them is case 6's
    assert new["max_abs_err"] == pytest.approx(7e-3)
    assert old["name"] == "flash_attention_bwd"
    assert (old["launches"], old["on_main_path"]) == (0, False)
    assert old["at"]["dtype"] == "float32"
    # the largest error among the other cases is the last of them's
    last = max(i for i, c in enumerate(chip_smoke.BWD_CASES)
               if not (c[6] == "bfloat16" and c[5] in (64, 128)))
    assert old["max_abs_err"] == pytest.approx(1e-3 * (last + 1))
    f32 = chip_smoke.bwd_kernel_entry("bwd", cases,
                                      {"f32_serve": 0, "f32_train": 24})
    assert (f32["launches"], f32["on_main_path"]) == (24, True)


def test_counts_are_the_four_kernels_in_order():
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    fa.launches_wgmma, fa.launches_simple = 1, 2
    fa.launches_bwd_wgmma, fa.launches_bwd = 3, 4
    assert dict(zip(chip_smoke.KERNELS, chip_smoke.counts(fa))) == {
        "wgmma": 1, "simple": 2, "bwd_wgmma": 3, "bwd": 4}
    chip_smoke.reset_counts(fa)
    assert chip_smoke.counts(fa) == (0, 0, 0, 0)


def test_compare_turns_alternate_trees_and_collect_device_ms(monkeypatch):
    """--compare-bwd runs the other tree, this one, this one, the other,
    each on the bf16 d 64/128 backward cases and K1's two main shapes, and
    files each turn's device ms under its tree."""
    import json
    import subprocess
    from pathlib import Path
    calls = []

    def run(cmd, cwd, capture_output, text, timeout):
        calls.append(cwd)
        fwd, bwd = json.loads(cmd[-1])
        assert [tuple(c) for c in fwd] == [chip_smoke.MAIN_CASE["wgmma"],
                                           chip_smoke.KERNEL_CASES[13]]
        assert len(bwd) == 7 and all(c[6] == "bfloat16" for c in bwd)
        ms = 1.0 if cwd == Path("/other") else 2.0
        lines = [json.dumps({"bwd_case": _bwd_row("x", c, ms, 0.0)})
                 for c in bwd]
        lines.append(json.dumps({"kernel_case": _bwd_row("x", fwd[0], ms,
                                                         0.0)}))
        return subprocess.CompletedProcess(cmd, 0, "\n".join(lines), "")

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    got = chip_smoke.compare_turns(Path("/other"), Path("/this"))
    assert calls == [Path("/other"), Path("/this"), Path("/this"),
                     Path("/other")]
    assert len(got["bwd"]) == 7 and len(got["fwd"]) == 1
    for per_tree in list(got["bwd"].values()) + list(got["fwd"].values()):
        assert per_tree == {"other": [1.0, 1.0], "this": [2.0, 2.0]}
    assert "fused 8 16 1024 1024 64 True" in got["bwd"]


def test_serialized_wgmma_warnings_are_found():
    log = _BWD_PTXAS.format(s=0) + (
        "ptxas warning : (C7514) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to ...\n")
    assert chip_smoke.serialized_wgmma(_BWD_PTXAS.format(s=0)) == []
    assert len(chip_smoke.serialized_wgmma(log)) == 1


def test_profile_window_lists_every_attention_kernel(tmp_path, monkeypatch):
    """Besides the top kernels, the window names every kernel of K1 and K2
    (the wgmma and mma.sync ones, and the small D pass) and of K3 (the
    merge too), each with its device time and count."""
    import json
    import torch
    import torch.profiler as tp

    def kernel(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {}}

    events = [
        {"ph": "X", "cat": "user_annotation", "name": "chip_smoke.w",
         "ts": 0, "dur": 100},
        kernel("nvjet_tst_256x128", 0, 50),
        kernel("void flash_fwd_wgmma_kernel<64>(...)", 50, 10),
        kernel("void flash_bwd_wgmma_kernel<64, true>(...)", 60, 9),
        kernel("void flash_bwd_wgmma_kernel<64, true>(...)", 69, 9),
        kernel("void delta_kernel<__nv_bfloat16>(DeltaArgs)", 78, 1),
        kernel("void dq_kernel_bf16<64>(Args)", 79, 5),
        kernel("void dkdv_kernel_bf16<64>(Args)", 84, 6),
        kernel("void ce_wgmma_kernel<false>(CUtensorMap_st, Args)", 90, 4),
        kernel("void ce_merge_kernel(float const*, int, int)", 94, 1),
        kernel("void ce_wgmma_kernel<true>(CUtensorMap_st, Args)", 95, 2),
        kernel("void ce_wgmma_kernel<true>(CUtensorMap_st, Args)", 97, 2),
        kernel("void (anonymous namespace)::paged_attend_kernel<1, 0, 1, "
               "8>((anonymous namespace)::AttendArgs)", 97, 2)]

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": events}))

    from pathlib import Path
    monkeypatch.setattr(tp, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path / "out")
    row = chip_smoke.profile_window(torch, "w", lambda: None, "t.json", top=1)
    assert [k["name"] for k in row["top_kernels"]] == ["nvjet_tst_256x128"]
    got = {k["name"]: (k["us"], k["count"]) for k in row["attention_kernels"]}
    assert got == {
        "void flash_bwd_wgmma_kernel<64, true>(...)": (18.0, 2),
        "void flash_fwd_wgmma_kernel<64>(...)": (10.0, 1),
        "void dkdv_kernel_bf16<64>(Args)": (6.0, 1),
        "void dq_kernel_bf16<64>(Args)": (5.0, 1),
        "void delta_kernel<__nv_bfloat16>(DeltaArgs)": (1.0, 1)}
    got = {k["name"]: (k["us"], k["count"]) for k in row["ce_kernels"]}
    assert got == {
        "void ce_wgmma_kernel<false>(CUtensorMap_st, Args)": (4.0, 1),
        "void ce_merge_kernel(float const*, int, int)": (1.0, 1),
        "void ce_wgmma_kernel<true>(CUtensorMap_st, Args)": (4.0, 2)}
    assert [(k["us"], k["count"]) for k in row["decode_kernels"]] == [
        (2.0, 1)]
    assert row["busy_share"] == pytest.approx(0.99)   # 99 of 100 us


def test_f32_ce_bounds_are_three_tf32_products_and_the_fma_rate():
    """f32 K3f at the training shape: 549.8 GFLOP, 3.33 ms as three TF32
    products at the 495 TFLOP/s peak, 8.21 ms at the 67 TFLOP/s FMA rate;
    the split pass moves x and E in and two parts of each out: 480 MB,
    0.14 ms at 3.35 TB/s."""
    flops = 2.0 * 8192 * 32768 * 1024
    ms, by = chip_smoke.ce_fwd_bound_ms(8192, 32768, 1024, "float32")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flops / (495e12 / 3))
    fma, _ = chip_smoke.ce_fwd_bound_ms(8192, 32768, 1024, "float32",
                                        chip_smoke.PEAK_FLOPS)
    assert fma == pytest.approx(8.206, rel=1e-3)
    b, _ = chip_smoke.ce_dlogits_bound_ms(8192, 4096, 1024, "float32")
    assert b == pytest.approx(ms / 8)
    sp, by_s = chip_smoke.ce_split_bound_ms(8192, 32768, 1024)
    assert by_s == "bytes"
    assert sp == pytest.approx(1e3 * 4 * 40960 * 3 * 1024 / 3.35e12)
    # rows of d 48 are written 64 wide
    assert chip_smoke.ce_split_bound_ms(10, 6, 48)[0] == pytest.approx(
        1e3 * 4 * 16 * (48 + 128) / 3.35e12)


def test_ce_cases_hold_both_training_shapes():
    """The f32 training shape is a K3 case of its own, timed in turns
    against chunked_ce.cu's kernels as the bf16 one is; the toy f32 case
    stays."""
    f32 = (8192, 32768, 1024, "float32", 8)
    assert f32 in chip_smoke.CE_CASES
    assert (1024, 4096, 256, "float32", 4) in chip_smoke.CE_CASES
    assert chip_smoke.CE_TURN_CASES == (chip_smoke.CE_CASES[0], f32)
    assert chip_smoke.CE_PRECISION_CASE == f32
    for k in ("ce_fwd", "ce_dlogits", "ce_fwd_tf32", "ce_dlogits_tf32",
              "ce_split_tf32"):
        assert chip_smoke.CE_MAIN_CASE[k] == f32


_CE_TF32_PTXAS = "".join(
    f"ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__x_18_chunk"
    f"ed_ce_tf32_cu_y14ce_tf32_kernelILb{k}EEEv14CUtensorMap_stS1_S1_S1_NS_"
    f"4ArgsE' for 'sm_90a'\n    0 bytes stack frame, {sp} bytes spill "
    f"stores, 0 bytes spill loads\nptxas info    : Used 168 registers, used "
    f"1 barriers\n"
    for k, sp in ((0, 0), (1, 8))) + (
    "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__x_18_chunked"
    "_ce_tf32_cu_y15ce_split_kernelEPKfxiS1_xiiiPfS2_S2_S2_' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 30 registers, used 0 barriers\n")


def test_ptxas_report_of_each_ce_tf32_kernel():
    """The tf32 K3f and K3b and the split pass, by name; a spill in one
    fails the check."""
    report = chip_smoke.ce_tf32_ptxas(_CE_TF32_PTXAS)
    assert sorted(report) == chip_smoke.CE_TF32_INSTANTIATIONS
    assert len(report) == 3
    assert report["split"] == {"registers": 30, "spill_bytes": 0}
    assert report["fwd"] == {"registers": 168, "spill_bytes": 0}
    assert report["dlogits"]["spill_bytes"] == 8
    assert not chip_smoke.spill_free(report,
                                     chip_smoke.CE_TF32_INSTANTIATIONS)
    report["dlogits"]["spill_bytes"] = 0
    assert chip_smoke.spill_free(report, chip_smoke.CE_TF32_INSTANTIATIONS)


def test_ce_bounds_at_the_training_shape():
    """K3f at the bench's large config, batch 8: 2·8192·32768·1024 =
    549.8 GFLOP, 0.556 ms at the dense bf16 peak; one K3b launch (a 4096-
    column chunk) an eighth of that, also bound by its products."""
    ms, by = chip_smoke.ce_fwd_bound_ms(8192, 32768, 1024, "bfloat16")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 2.0 * 8192 * 32768 * 1024 / 989e12)
    assert ms == pytest.approx(0.556, rel=1e-3)
    ms_b, by_b = chip_smoke.ce_dlogits_bound_ms(8192, 4096, 1024,
                                                "bfloat16")
    assert by_b == "operations" and ms_b == pytest.approx(ms / 8)
    # a tiny call is bound by its bytes: x, the chunk, targets, lse, dlogits
    ms_t, by_t = chip_smoke.ce_dlogits_bound_ms(1, 3, 16, "float32")
    assert by_t == "bytes"
    assert ms_t == pytest.approx(
        1e3 * (4 * 4 * 16 + 12 + 4 * 3) / chip_smoke.PEAK_BYTES)


def test_moe_bound_at_the_training_shape():
    """Dispatch at G 8192, d 1024, E 8, C 1280, bf16: 16.8 MB of kept rows
    read and 21.0 MB of expert rows written, ≈ 11 µs at 3.35 TB/s."""
    ms, by = chip_smoke.moe_bound_ms(8192, 8 * 1280, 1024, "bfloat16",
                                     4 * 8 * 1280)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (2 * 1024 * (8192 + 10240) + 40960)
                               / 3.35e12)
    assert ms == pytest.approx(0.0113, rel=1e-2)


def test_expected_launches_per_step():
    """K1 twice per layer under remat (its recompute), K2 once, the wgmma
    K3f once and K3b per ce chunk (chunked_ce.cu's never: the large
    config is bf16 at d 1024), K7 twice per MoE layer (three times under
    remat), K4a, K4w and K4a+w (decode only) never."""
    assert chip_smoke.expected_per_step(12, False, 0) == (
        12, 0, 12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    assert chip_smoke.expected_per_step(12, True, 8) == (
        24, 0, 12, 0, 0, 0, 0, 0, 1, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    assert chip_smoke.expected_per_step(12, False, 8, moe=True) == (
        12, 0, 12, 0, 0, 0, 24, 24, 1, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    assert chip_smoke.expected_per_step(2, True, 0, moe=True)[6:] == (
        6, 6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    assert len(chip_smoke.ALL_KERNELS) == 21
    assert chip_smoke.ALL_KERNELS[:4] == chip_smoke.KERNELS
    assert chip_smoke.ALL_KERNELS[8:10] == ("ce_fwd_wgmma",
                                            "ce_dlogits_wgmma")
    assert {chip_smoke.SOURCES[k] for k in chip_smoke.ALL_KERNELS[8:10]} == {
        "chunked_ce_wgmma.cu"}
    assert chip_smoke.ALL_KERNELS[10:12] == ("paged_attention",
                                             "kv_quant_write")
    assert {chip_smoke.SOURCES[k] for k in chip_smoke.ALL_KERNELS[10:12]} \
        == {"paged_attention.cu"}
    assert chip_smoke.ALL_KERNELS[12:15] == ("ce_fwd_tf32", "ce_dlogits_tf32",
                                             "ce_split_tf32")
    assert {chip_smoke.SOURCES[k] for k in chip_smoke.ALL_KERNELS[12:15]} \
        == {"chunked_ce_tf32.cu"}
    assert chip_smoke.ALL_KERNELS[15] == "paged_attention_write"
    assert chip_smoke.SOURCES["paged_attention_write"] == "paged_attention.cu"
    assert chip_smoke.ALL_KERNELS[16:20] == ("rnn_cell_fwd", "rnn_cell_bwd",
                                             "rnn_layer_fwd", "rnn_layer_bwd")
    assert {chip_smoke.SOURCES[k] for k in chip_smoke.ALL_KERNELS[16:20]} \
        == {"rnn_cell.cu"}
    # the last count is no kernel's: the attention op's plain route
    assert chip_smoke.ALL_KERNELS[20] == "attention_plain"
    assert "attention_plain" not in chip_smoke.SOURCES


def test_all_counts_reads_every_counter_in_order():
    """all_counts gives the twenty-one counters in ALL_KERNELS' order, and
    reset_all_counts zeroes every one."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
    names = [(fa, "launches_wgmma"), (fa, "launches_simple"),
             (fa, "launches_bwd_wgmma"), (fa, "launches_bwd"),
             (ce, "launches_fwd"), (ce, "launches_dlogits"),
             (mr, "launches_dispatch"), (mr, "launches_combine"),
             (ce, "launches_fwd_wgmma"), (ce, "launches_dlogits_wgmma"),
             (pa, "launches_attend"), (pa, "launches_quant_write"),
             (ce, "launches_fwd_tf32"), (ce, "launches_dlogits_tf32"),
             (ce, "launches_split_tf32"), (pa, "launches_attend_write"),
             (rc, "launches_cell_fwd"), (rc, "launches_cell_bwd"),
             (rc, "launches_layer_fwd"), (rc, "launches_layer_bwd"),
             (fa, "plain_route_calls")]
    saved = [getattr(m, n) for m, n in names]
    try:
        for i, (m, n) in enumerate(names):
            setattr(m, n, i + 1)
        assert chip_smoke.all_counts() == tuple(range(1, 22))
        before = chip_smoke.all_counts()
        pa.launches_attend += 5
        ce.launches_split_tf32 += 2
        pa.launches_attend_write += 3
        rc.launches_cell_bwd += 4
        rc.launches_layer_fwd += 6
        assert chip_smoke.delta(before) == (0,) * 10 + (5, 0, 0, 0, 2, 3,
                                                        0, 4, 6, 0, 0)
        chip_smoke.reset_all_counts()
        assert chip_smoke.all_counts() == (0,) * 21
    finally:
        for (m, n), v in zip(names, saved):
            setattr(m, n, v)


def test_dlogits_errors_see_a_wrong_softmax_beside_the_targets():
    """A softmax wrong by 10 % off the targets fails the off-target check,
    though the target entries dominate any norm over all entries."""
    import torch
    n, c = 64, 512
    g = torch.Generator().manual_seed(1)
    p = torch.softmax(torch.randn((n, c), generator=g), -1)
    t = torch.randint(0, c, (n,), generator=g)
    ref = p.clone()
    ref[torch.arange(n), t] -= 1.0
    bad = ref * torch.where(torch.nn.functional.one_hot(t, c).bool(), 1.0,
                            1.1)
    rel, at = chip_smoke.dlogits_errors(bad, ref, t, 1.0)
    assert rel == pytest.approx(0.1, rel=1e-4) and at == 0.0
    whole = ((bad - ref).norm() / ref.norm()).item()
    assert whole < chip_smoke.TOL_CE_DLOG_L2["bfloat16"] * 4
    rel0, at0 = chip_smoke.dlogits_errors(ref, ref, torch.full((n,), -1),
                                          1.0)
    assert rel0 == 0.0 and at0 == 0.0


def test_kernels_line_entries_of_k3_and_k7():
    """K3f and K3b (all three designs), the split pass, K7d and K7c get
    kernels-line entries with every key the line needs: the wgmma K3 and K7
    from their cases' first (training-layer) row, the tf32 K3 and the split
    from the f32 training case, chunked_ce.cu's K3 from its forced run
    there; each K3 entry with both designs' turns at its training shape,
    the f32 ones with the FMA-rate bound beside."""
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    ce_row = {f"{p}_{k}": 1.0 for p in ("fwd", "dlogits")
              for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    ce_row.update(fwd_bound_by="operations", dlogits_bound_by="operations",
                  library="x", library_ms=2.0, library_device_ms=2.0,
                  library_bwd_ms=3.0, library_bwd_device_ms=3.0,
                  backward_ms=4.0, backward_device_ms=4.0,
                  max_abs_err_lse=1e-5, max_abs_err_dlogits=1e-6)
    ce_cases = {c: dict(ce_row, path="tf32" if c[3] == "float32"
                        else "wgmma") for c in chip_smoke.CE_CASES}
    f32_main = chip_smoke.CE_MAIN_CASE["ce_fwd_tf32"]
    assert f32_main == (8192, 32768, 1024, "float32", 8)
    turns = {w: {"mma_sync": [3.0, 3.1], "wgmma": [1.0, 1.1]}
             for w in ("fwd", "dlogits")}
    turns32 = {w: {"mma_sync": [20.0, 20.1], "tf32": [4.5, 4.6]}
               for w in ("fwd", "dlogits")}
    ce_cases[chip_smoke.CE_CASES[0]].update(turns_device_ms=turns,
                                            fwd_ms=7.0, max_abs_err_lse=2e-5)
    ce_cases[f32_main].update(
        turns_device_ms=turns32, fwd_ms=5.0, fwd_bound_fma_ms=8.2,
        dlogits_bound_fma_ms=1.0,
        mma_sync={"fwd_ms": 21.0, "fwd_device_ms": 20.05,
                  "dlogits_ms": 2.3, "dlogits_device_ms": 2.2,
                  "max_abs_err_lse": 3e-6, "max_abs_err_dlogits": 4e-9},
        split={"exact": True, "ms": 0.2, "device_ms": 0.18,
               "plain_ms": 9.0, "bound_ms": 0.14, "bound_by": "bytes"})
    launches = {"serve": 0, "train": 21, "moe": 7}
    # chunked_ce.cu's K3 runs on no main path since the tf32 kernels
    off_path = {"serve": 0, "train": 0, "moe": 0, "f32_train": 0}
    on_f32 = dict(off_path, f32_train=5)
    fwd = chip_smoke.ce_kernel_entry("ce_fwd", ce_cases, off_path)
    dlog = chip_smoke.ce_kernel_entry("ce_dlogits", ce_cases, off_path)
    fwd_w = chip_smoke.ce_kernel_entry("ce_fwd_wgmma", ce_cases, launches)
    dlog_w = chip_smoke.ce_kernel_entry("ce_dlogits_wgmma", ce_cases,
                                        launches)
    fwd_t = chip_smoke.ce_kernel_entry("ce_fwd_tf32", ce_cases, on_f32)
    dlog_t = chip_smoke.ce_kernel_entry("ce_dlogits_tf32", ce_cases, on_f32)
    split = chip_smoke.ce_kernel_entry("ce_split_tf32", ce_cases, on_f32)
    assert (fwd_w["ms"], fwd_t["ms"], fwd["ms"]) == (7.0, 5.0, 21.0)
    assert (fwd["device_ms"], dlog["device_ms"]) == (20.05, 2.2)
    assert (fwd_w["max_abs_err"], fwd["max_abs_err"]) == (2e-5, 3e-6)
    assert fwd_w["name"] == "chunked_ce_fwd_wgmma" and fwd_w["on_main_path"]
    assert fwd_t["name"] == "chunked_ce_fwd_tf32" and fwd_t["on_main_path"]
    assert dlog_t["name"] == "chunked_ce_dlogits_tf32"
    assert dlog_w["source"].endswith("csrc/chunked_ce_wgmma.cu")
    assert dlog_t["source"].endswith("csrc/chunked_ce_tf32.cu")
    assert fwd["source"].endswith("csrc/chunked_ce.cu")
    assert not fwd["on_main_path"] and fwd["at"]["dtype"] == "float32"
    assert fwd_t["launches"] == split["launches"] == 5
    assert (fwd_t["bound_fma_ms"], dlog_t["bound_fma_ms"]) == (8.2, 1.0)
    assert "bound_fma_ms" not in fwd_w
    for entry, t in ((fwd, turns32), (dlog, turns32), (fwd_w, turns),
                     (dlog_w, turns), (fwd_t, turns32), (dlog_t, turns32)):
        what = "fwd" if "fwd" in entry["name"] else "dlogits"
        assert entry["turns_device_ms_at_training_shape"] == t[what]
    assert dlog_t["backward_ms"] == 4.0 and "backward_ms" not in dlog
    assert split["name"] == "chunked_ce_split_tf32"
    assert (split["max_abs_err"], split["bound_by"], split["library_ms"]) \
        == (0.0, "bytes", None)
    moe_row = {f"{p}_{k}": 1.0 for p in ("dispatch", "combine")
               for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "library_ms", "library_device_ms")}
    moe_row.update(dispatch_bound_by="bytes", combine_bound_by="bytes",
                   library="y", max_abs_err={"combine": 1e-3,
                                             "dispatch_grad": 2e-3,
                                             "d_gate": 5e-3})
    moe_cases = {c: dict(moe_row) for c in chip_smoke.MOE_CASES}
    disp = chip_smoke.moe_kernel_entry("moe_dispatch", moe_cases, launches)
    comb = chip_smoke.moe_kernel_entry("moe_combine", moe_cases, launches)
    for entry in (fwd, dlog, fwd_w, dlog_w, fwd_t, dlog_t, split, disp,
                  comb):
        for key in keys:
            assert key in entry, (entry["name"], key)
        assert entry["route"] == "cuda" and entry["launches"] == (
            0 if entry is fwd or entry is dlog else 5
            if entry in (fwd_t, dlog_t, split) else 28)
    assert fwd["replaces"].endswith("chunked_ce.py:40")
    assert dlog["replaces"].endswith("chunked_ce.py:85")
    assert dlog_t["replaces"].endswith("chunked_ce.py:85")
    assert dlog_w["library_ms"] == 3.0 and dlog_w["backward_ms"] == 4.0
    assert disp["source"].endswith("csrc/moe_route.cu")
    assert disp["replaces"].endswith("moe.py:132")
    assert comb["replaces"].endswith("moe.py:143")
    assert (disp["max_abs_err"], comb["max_abs_err"]) == (5e-3, 2e-3)


def test_plain_kernels_swaps_every_kernel_out_and_back():
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    names = [(fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
             (ce, "chunked_ce_fwd"), (ce, "ce_dlogits"), (ce, "split_tf32"),
             (mr, "moe_dispatch"), (mr, "moe_combine"),
             (mr, "moe_dispatch_grad")]
    before = [getattr(m, n) for m, n in names]
    with chip_smoke.plain_kernels(fa):
        during = [getattr(m, n) for m, n in names]
        assert all(a is not b for a, b in zip(before, during))
        assert mr.moe_combine is mr.combine_reference
    assert [getattr(m, n) for m, n in names] == before


def test_k4a_bound_counts_only_the_keys_the_data_needs():
    """The main decode step (B 1, W 1, context 1024, bf16 pages of 64, H 16,
    hd 64): 4096 B a key position (k and v) plus q, o, the position and 16
    table entries: 4.19 MB, 1.25 µs at 3.35 TB/s, bound by bytes. int8
    pages: 2048 + 8 B a position, 0.63 µs. A window past S counts S keys;
    a short context counts its own."""
    import torch
    case = chip_smoke.DECODE_CASES[0]
    ms, by = chip_smoke.k4a_bound_ms(case, torch.tensor([[1023]]))
    want = 1024 * 4096 + 4 * 16 + 4 + 2 * 1024 * 2
    assert by == "bytes" and ms == pytest.approx(1e3 * want / 3.35e12)
    assert ms == pytest.approx(1.25e-3, rel=5e-3)
    ms8, _ = chip_smoke.k4a_bound_ms(chip_smoke.DECODE_CASES[7],
                                     torch.tensor([[1023]]))
    assert ms8 == pytest.approx(1e3 * (1024 * 2056 + 68 + 4096) / 3.35e12)
    assert ms8 == pytest.approx(0.63e-3, rel=1e-2)
    past, _ = chip_smoke.k4a_bound_ms(case, torch.tensor([[1500]]))
    assert past == ms
    short, _ = chip_smoke.k4a_bound_ms(case, torch.tensor([[36]]))
    assert short == pytest.approx(1e3 * (37 * 4096 + 4 + 4 + 4096)
                                  / 3.35e12)
    b8, _ = chip_smoke.k4a_bound_ms(chip_smoke.DECODE_CASES[6],
                                    torch.tensor([[1019, 1020, 1021, 1022,
                                                   1023]] * 8))
    assert b8 == pytest.approx(1e-2, rel=2e-2)        # 33.6 MB, 10.0 µs


def test_k4w_bound_is_rows_read_and_int8_written():
    ms, by = chip_smoke.k4w_bound_ms(1, 1, 1, 1024, "bfloat16")
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (2 * 1024 * 2 + 2 * 1024 + 8 + 8)
                               / 3.35e12)
    ms, _ = chip_smoke.k4w_bound_ms(32, 64, 12, 1024, "bfloat16")
    assert ms == pytest.approx(1e3 * (12 * (2 * 32 * 2048 + 2 * 64 * 1024
                                            + 8 * 64) + 8 * 64) / 3.35e12)


def test_k4aw_bound_adds_the_store_to_k4a():
    """K4a+w's bound is K4a's plus the window's k and v rows read from the
    projection, the stored rows written (int8 with their scales) and their
    pool rows read; a dropped row (-1) is not written."""
    import torch
    case = chip_smoke.DECODE_CASES[0]
    pos = torch.tensor([[1023]])
    base = 1024 * 4096 + 4 * 16 + 4 + 2 * 1024 * 2
    ms, by = chip_smoke.k4aw_bound_ms(case, pos, torch.tensor([[70]]))
    want = base + 2 * 1024 * 2 + 4 + 2 * 1024 * 2
    assert by == "bytes" and ms == pytest.approx(1e3 * want / 3.35e12)
    dropped, _ = chip_smoke.k4aw_bound_ms(case, pos, torch.tensor([[-1]]))
    assert dropped == pytest.approx(1e3 * (want - 4096) / 3.35e12)
    ms8, _ = chip_smoke.k4aw_bound_ms(chip_smoke.DECODE_CASES[7], pos,
                                      torch.tensor([[70]]))
    want8 = (1024 * 2056 + 68 + 4096) + 2 * 1024 * 2 + 4 + 2 * (1024 + 4)
    assert ms8 == pytest.approx(1e3 * want8 / 3.35e12)


def test_launch_counts_names_each_kernel():
    """A launch tuple in ALL_KERNELS' order from the kernels' names, 0 for
    the rest; a name that is no kernel raises."""
    got = chip_smoke.launch_counts(wgmma=12, paged_attention_write=372,
                                   kv_quant_write=1)
    assert len(got) == len(chip_smoke.ALL_KERNELS) == 21
    assert dict(zip(chip_smoke.ALL_KERNELS, got)) == dict(
        {k: 0 for k in chip_smoke.ALL_KERNELS}, wgmma=12,
        paged_attention_write=372, kv_quant_write=1)
    with pytest.raises(ValueError, match="no such kernels"):
        chip_smoke.launch_counts(paged_attention_fused=1)


def test_fused_cases_are_the_decode_steps_and_the_verify_window():
    """K4a+w is checked at DECODE_CASES' main step on bf16 and int8 pages
    and the dense view, the verify window at B 8, a window past S with a
    free slot, and f32 pages; the first four are timed in turns against
    the two-launch path; K4w's first case is the bucket-1024 insert."""
    d = chip_smoke.DECODE_CASES
    assert chip_smoke.FUSED_TURN_CASES == [d[0], d[7], d[11], d[6]]
    assert d[17] in chip_smoke.FUSED_CASES and d[16] in chip_smoke.FUSED_CASES
    assert [c[7] for c in chip_smoke.FUSED_CASES[:3]] == ["same", "int8",
                                                          "same"]
    assert chip_smoke.FUSED_CASES[2][4:6] == (1024, 1)     # the dense view
    assert chip_smoke.QUANT_CASES[0] == (1, 1024, 12, 64, "bfloat16")
    assert chip_smoke.FUSED_MAIN_CASE["paged_attention_write"] == d[0]


@pytest.mark.parametrize("window, pool, page_tokens", [
    (1, "same", 64), (chip_smoke.SPEC_K + 1, "int8", 64), (1, "same", 1024)],
    ids=["decode_bf16_pages", "verify_int8_pages", "draft_dense"])
def test_fused_cases_hold_the_pipelines_shapes(window, pool, page_tokens):
    """The pipeline runs K4a+w with PIPE_SLOTS slots, each at its own
    position: the decode step on bf16 pages, the verify window on int8
    pages and the draft's step on its dense cache; each of those shapes is
    a K4a+w case held to its plain version."""
    ctx = tuple(sorted(chip_smoke.PROMPT_LENS))
    n_lp = 1024 // page_tokens
    case = (chip_smoke.PIPE_SLOTS, window, 16, 64, page_tokens, n_lp,
            "bfloat16", pool, ctx, ())
    assert case in chip_smoke.PIPE_FUSED_CASES
    assert case in chip_smoke.FUSED_CASES


class _Engine:
    def __init__(self):
        self.calls = 0

    def decode(self, n):
        self.calls += 1
        return n


def test_step_gate_lets_whole_steps_through():
    """The gate holds the decode thread at a step's start, lets exactly
    ``steps`` calls through on run(), returns with the thread held at the
    next one, and releases it (and unwraps decode) on leaving."""
    import threading
    eng = _Engine()
    stop = threading.Event()
    done = []

    def loop():
        while not stop.is_set():
            done.append(eng.decode(len(done)))

    th = threading.Thread(daemon=True, target=loop)
    try:
        with chip_smoke.StepGate(eng, 3, timeout=10) as gate:
            th.start()
            assert gate.held()
            assert eng.calls == 0
            gate.run()
            assert eng.calls == 3 and done == [0, 1, 2]
            gate.run()
            assert eng.calls == 6
            stop.set()
    finally:
        # a failed check must not leave the loop spinning past the gate
        stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    assert eng.calls == 7 and "decode" not in vars(eng)


def test_k4w_ptxas_report_reads_both_instantiations():
    """K4w's two instantiations (bf16, f32 rows) are read from ptxas's
    report apart from K4a's, and a spill in either fails the check."""
    def entry(t, spill):
        name = (f"_ZN51_GLOBAL__N__0830ad88_18_paged_attention_cu_0889000418"
                f"quant_write_kernelI{t}EEvNS_9QuantArgsE")
        return (f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'\n    0 bytes stack frame, {spill} bytes spill "
                f"stores, {spill} bytes spill loads\nptxas info    : Used "
                f"48 registers, used 0 barriers\n")
    log = entry("f", 0) + entry("13__nv_bfloat16", 0)
    report = chip_smoke.k4w_ptxas(log)
    assert report == {"f32": {"registers": 48, "spill_bytes": 0},
                      "bf16": {"registers": 48, "spill_bytes": 0}}
    assert chip_smoke.spill_free(report, chip_smoke.K4W_INSTANTIATIONS)
    assert chip_smoke.k4a_ptxas(log) == {}
    spilled = chip_smoke.k4w_ptxas(entry("f", 8) + entry("13__nv_bfloat16",
                                                         0))
    assert not chip_smoke.spill_free(spilled, chip_smoke.K4W_INSTANTIATIONS)


def test_k4a_readonly_loads_counts_wide_constant_loads_per_kernel():
    """The SASS check of K4a+w's coherence: 64- and 128-bit loads through
    the read-only path are counted in each K4a function and nowhere else
    (K4w may read its rows that way)."""
    def fn(name, *ops):
        return (f"\n\tFunction : _ZN1x{name}\n" + "".join(
            f"        /*0{i}0*/   {op} R8, desc[UR6][R40.64] ;\n"
            for i, op in enumerate(ops)))
    sass = ("code for sm_90a" + fn("19paged_attend_kernelILi1ELi0ELi1ELi8EE",
                                   "LDG.E.128.STRONG.SM", "LDG.E.CONSTANT")
            + fn("19paged_attend_kernelILi1ELi1ELi1ELi16EE",
                 "LDG.E.64.STRONG.SM")
            + fn("18quant_write_kernelIfEE", "LDG.E.128.CONSTANT"))
    loads = chip_smoke.k4a_readonly_loads(sass)
    assert len(loads) == 2 and sum(loads.values()) == 0
    bad = sass.replace("LDG.E.64.STRONG.SM", "LDG.E.64.CONSTANT")
    assert sorted(chip_smoke.k4a_readonly_loads(bad).values()) == [0, 1]


def test_near_tie_step_finds_the_first_close_top_two():
    import numpy as np
    steps = [np.array([[0.0, 2.0, 1.0]]), np.array([[0.5, 0.55, 0.1]]),
             np.array([[3.0, 0.0, 2.95]])]
    assert chip_smoke.near_tie_step(steps) == 1
    assert chip_smoke.near_tie_step(steps[:1]) is None
    assert chip_smoke.near_tie_step([np.array([[1.0, 1.05]])]) == 0


def test_kernels_line_entries_of_k4():
    """K4a, K4w and K4a+w get kernels-line entries with every key the line
    needs: K4a's numbers at the main decode step with its int8 and
    dense-view cases beside them (no main path calls it alone since
    K4a+w), K4w's at the bucket-1024 insert with no library call, K4a+w's
    at the decode step on bf16 pages with the two-launch path's times and
    its int8 and dense cases beside."""
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    row = {k: 1.0 for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                            "library_ms", "library_device_ms")}
    cases = {c: dict(row, bound_by="bytes", max_abs_err=1e-3)
             for c in chip_smoke.DECODE_CASES}
    cases[chip_smoke.DECODE_CASES[0]].update(ms=7.0, max_abs_err=4e-3)
    cases[chip_smoke.DECODE_CASES[7]].update(ms=8.0)
    for c in chip_smoke.QUANT_CASES:
        cases[("quant",) + c] = dict(row, bound_by="bytes", max_abs_err=0.0,
                                     library_ms=None)
    cases[("quant",) + chip_smoke.QUANT_CASES[0]].update(ms=3.0)
    for c in chip_smoke.FUSED_CASES:
        cases[("fused",) + c] = dict(row, bound_by="bytes", max_abs_err=2e-3,
                                     library_ms=None, two_launch_ms=2.0,
                                     two_launch_device_ms=1.5)
    cases[("fused",) + chip_smoke.DECODE_CASES[0]].update(ms=9.0)
    launches = {"serve": 372, "serve_modes": 900, "train": 0, "moe": 0}
    a = chip_smoke.decode_kernel_entry("paged_attention", cases, launches)
    w = chip_smoke.decode_kernel_entry("kv_quant_write", cases, launches)
    f = chip_smoke.decode_kernel_entry("paged_attention_write", cases,
                                       launches)
    for entry in (a, w, f):
        for key in keys:
            assert key in entry, (entry["name"], key)
        assert entry["route"] == "cuda" and entry["launches"] == 1272
        assert entry["source"].endswith("csrc/paged_attention.cu")
    assert a["replaces"].endswith("transformer.py:827")
    assert w["replaces"].endswith("transformer.py:107")
    assert f["replaces"].endswith("transformer.py:861")
    assert (a["ms"], a["int8"]["ms"], a["max_abs_err"]) == (7.0, 8.0, 4e-3)
    assert a["dense"]["ms"] == 1.0 and a["at"]["pool"] == "same"
    assert not a["on_main_path"] and w["on_main_path"] and f["on_main_path"]
    assert (w["ms"], w["library_ms"], w["max_abs_err"]) == (3.0, None, 0.0)
    assert w["at"]["layers"] == 12 and w["at"]["w"] == 1024
    assert (f["ms"], f["library_ms"], f["max_abs_err"]) == (9.0, None, 2e-3)
    assert f["two_launch_device_ms"] == 1.5
    assert f["int8"]["two_launch_ms"] == 2.0 and f["at"]["w"] == 1


def _k4a_entry(types, wm, e, spill=0):
    dt, kq = types
    name = (f"_ZN62_GLOBAL__N__5b1e4c2d_18_paged_attention_cu_7d3e9f1a19"
            f"paged_attend_kernelILi{dt}ELi{kq}ELi{wm}ELi{e}EEEvNS_10"
            f"AttendArgsE")
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
            f"bytes spill loads\nptxas info    : Used 96 registers, used 1 "
            f"barriers\n")


_K4A_BUILT = [((1, 0), w, 8) for w in (1, 5, 8)] + [
    ((0, 0), w, 4) for w in (1, 5, 8)] + [((0, 0), w, 8) for w in (1, 5)] + [
    ((t, 1), 1, 16) for t in (1, 0)] + [
    ((t, 1), w, 8) for t in (1, 0) for w in (1, 5, 8)]


@pytest.mark.parametrize("spilled", [None, 0, 7, 15])
def test_k4a_ptxas_report_holds_every_instantiation_to_no_spills(spilled):
    """Each of K4a's 16 instantiations is read from ptxas's report under a
    readable key (dtype/pool, queries a warp, elements a chunk); the check
    passes only when all 16 are there without spills, and the K4w kernel's
    lines are not K4a's."""
    log = "".join(_k4a_entry(*c, spill=64 if n == spilled else 0)
                  for n, c in enumerate(_K4A_BUILT))
    log += ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118"
            "quant_write_kernelIfEEvNS_9QuantArgsE' for 'sm_90a'\n    0 "
            "bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n")
    report = chip_smoke.k4a_ptxas(log)
    assert sorted(report) == chip_smoke.K4A_INSTANTIATIONS
    assert report["bf16/same w1 e8"]["registers"] == 96
    assert "bf16/int8 w1 e16" in report and "f32/same w8 e4" in report
    ok = chip_smoke.spill_free(report, chip_smoke.K4A_INSTANTIATIONS)
    assert ok == (spilled is None)
    missing = chip_smoke.k4a_ptxas("".join(_k4a_entry(*c)
                                           for c in _K4A_BUILT[1:]))
    assert not chip_smoke.spill_free(missing, chip_smoke.K4A_INSTANTIATIONS)


def test_split_sweep_row_names_the_rule_and_the_fastest():
    """The decode_split_sweep line: the case's shape, key_splits' choice,
    the fastest point, the rule's time over the fastest's, and each point
    as measured."""
    case = chip_smoke.DECODE_CASES[0]
    points = [{"splits": s, "keys_per_split": -(-1024 // s),
               "blocks": 16 * s, "max_abs_err": 1e-3, "device_ms": t}
              for s, t in ((8, 0.006), (16, 0.004), (32, 0.005))]
    row = chip_smoke.split_sweep_row(case, 16, points)
    assert (row["b"], row["w"], row["h"], row["hd"]) == (1, 1, 16, 64)
    assert row["contexts"] == [1024] and row["pool"] == "same"
    assert (row["rule_splits"], row["best_splits"]) == (16, 16)
    assert row["rule_vs_best"] == 1.0 and row["points"] == points
    row = chip_smoke.split_sweep_row(case, 8, points)
    assert row["rule_vs_best"] == pytest.approx(1.5)
    assert chip_smoke.split_sweep_row(case, 12, points)["rule_vs_best"] \
        is None
    assert set(chip_smoke.SPLIT_SWEEP) == {chip_smoke.DECODE_CASES[0],
                                           chip_smoke.DECODE_CASES[6]}


def test_exactness_fields_see_a_changed_bit():
    """``deterministic`` compares a second eager call with the first,
    ``replay_exact`` every replayed output, bit for bit."""
    import torch
    o = torch.tensor([1.0, -2.5, 3.0], dtype=torch.bfloat16)
    off = o.clone()
    off[1] = torch.tensor(-2.5, dtype=torch.bfloat16).view(
        torch.int16).add(1).view(torch.bfloat16)
    assert chip_smoke.exactness(o, o.clone(), [o.clone()] * 3) == {
        "deterministic": True, "replay_exact": True}
    assert chip_smoke.exactness(o, off, [o.clone()]) == {
        "deterministic": False, "replay_exact": True}
    assert chip_smoke.exactness(o, o.clone(), [o.clone(), off]) == {
        "deterministic": True, "replay_exact": False}
    assert not chip_smoke.exactness(o, o.clone(), [])["replay_exact"]


def test_new_decode_cases_are_the_many_split_and_widest_window():
    """The two cases appended for the one-launch K4a: 64 splits (one head,
    4096 keys in pages of 64) and W 16 at hd 128; the main cases keep their
    places."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    many, wide = chip_smoke.DECODE_CASES[-2:]
    assert pa.key_splits(many[0], many[2], many[4] * many[5])[0] == 64
    assert (wide[1], wide[3]) == (16, 128)
    assert chip_smoke.DECODE_MAIN_CASE["paged_attention"][:2] == (1, 1)
    assert chip_smoke.DECODE_MAIN_CASE["paged_attention_int8"][7] == "int8"


# ------------------------------------------------- the f32 path (PR 9 on)
def test_f32_attention_bound_is_three_tf32_products():
    """The f32 training layer (B 8 × H 16, T 1024, d 64, causal): the
    forward's 17.2 GFLOP and the backward's 43.0 over 165 TFLOP/s (three
    TF32 products at the 495 TFLOP/s peak), with the 67 TFLOP/s FMA bound
    beside; bf16 keeps 989 TFLOP/s."""
    pairs = 1024 * 1025 // 2
    ms, by = chip_smoke.attention_bound_ms(128, 1024, 1024, 64, "float32",
                                           True)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 4.0 * 128 * 64 * pairs / 165e12)
    fma, _ = chip_smoke.attention_bound_ms(128, 1024, 1024, 64, "float32",
                                           True, chip_smoke.PEAK_FLOPS)
    assert fma == pytest.approx(ms * 165 / 67)
    bwd, by = chip_smoke.attention_bwd_bound_ms(128, 1024, 1024, 64,
                                                "float32", True)
    assert by == "operations"
    assert bwd == pytest.approx(1e3 * 10.0 * 128 * 64 * pairs / 165e12)
    assert bwd == pytest.approx(0.26058, rel=1e-3)
    assert chip_smoke.ATTN_PEAK_FLOPS["bfloat16"] == \
        chip_smoke.PEAK_FLOPS["bfloat16"]
    # the f32 training step's MFU keeps the FMA rate: its GEMMs run there
    assert chip_smoke.PEAK_FLOPS["float32"] == 67e12


def test_expected_launches_per_step_of_the_f32_model():
    """f32: the simple forward and the mma.sync / FMA backward once per
    layer, the tf32 K3 with ce_chunks (K3f once, K3b a chunk, the split
    pass for the forward and before the backward's chunks; neither
    chunked_ce.cu's nor the wgmma one), no wgmma flash kernel."""
    assert chip_smoke.expected_per_step(12, False, 0, f32=True) == (
        0, 12, 0, 12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    assert chip_smoke.expected_per_step(12, False, 8, f32=True) == (
        0, 12, 0, 12, 0, 0, 0, 0, 0, 0, 0, 0, 1, 8, 2, 0, 0, 0, 0, 0, 0)
    assert chip_smoke.expected_per_step(12, True, 8, f32=True)[:4] == (
        0, 24, 0, 12)
    assert chip_smoke.F32_RUNGS == ((8, False, 0), (8, False, 8))
    assert chip_smoke.GRAD_RUNG in chip_smoke.F32_RUNGS
    assert chip_smoke.LARGE_F32 == dict(chip_smoke.LARGE, dtype="float32")


def _path_launches():
    """Plausible per-path launches, ALL_KERNELS' order: decode through
    K4a+w, K4w only for the int8 modes' prefill inserts (the serving modes
    and the pipeline's int8 run); the front door on bf16 pages, the
    fleet's f32 demo model on the simple forward; the recurrent path
    K11Lf and K11Lb 2 × 20 times each, the wide layer K11f and K11b 50
    times each; the attention op's plain route (the last count) never;
    the network, detection, transfer and scoring paths nothing."""
    L, n = 12, 31
    none, k11 = (0, 0, 0), (0, 0, 0, 0)
    serve = (4 * L, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0) + none + (4 * n * L,) \
        + k11
    modes = (3 * L, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12) + none + (900,) + k11
    train = (5 * L, 0, 5 * L, 0, 0, 0, 0, 0, 3, 24, 0, 0) + none + (0,) + k11
    moe = (L, 0, L, 0, 0, 0, 2 * L, 2 * L, 1, 8, 0, 0) + none + (0,) + k11
    f32_serve = (0, L, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0) + none + (n * L,) + k11
    f32_train = (0, 2 * L, 0, 2 * L, 0, 0, 0, 0, 0, 0, 0, 0, 1, 8, 2, 0) \
        + k11
    pipeline = (20 * L, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 8) + none + (2000,) \
        + k11
    frontdoor = (45 * L, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0) + none + (5868,) \
        + k11
    fleet = (0, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0) + none + (240,) + k11
    network = (0,) * 20
    recurrent = (0,) * 18 + (40, 40)
    wide = (0,) * 16 + (50, 50, 0, 0)
    detection = (0,) * 20
    transfer = (0,) * 20
    scoring = (0,) * 20
    return [path + (0,) for path in (
        serve, modes, train, moe, f32_serve, f32_train, pipeline, frontdoor,
        fleet, network, recurrent, wide, detection, transfer, scoring)]


@pytest.mark.parametrize("path,kernel,what", [
    (4, 0, "an f32 serving prefill on the wgmma forward"),
    (5, 2, "f32 training on the wgmma backward"),
    (5, 3, "f32 training without the mma.sync backward"),
    (4, 1, "f32 serving without the simple forward"),
    (2, 1, "bf16 training on the simple forward"),
    (0, 1, "bf16 serving on the simple forward"),
    (2, 3, "bf16 training on the mma.sync backward"),
    (5, 4, "f32 training on chunked_ce.cu's K3f"),
    (5, 8, "f32 training on the wgmma K3f"),
    (5, 12, "f32 training without the tf32 K3f"),
    (5, 13, "f32 training without the tf32 K3b"),
    (5, 14, "f32 training without the split pass"),
    (2, 12, "bf16 training on the tf32 K3f"),
    (0, 14, "serving launching the split pass"),
    (4, 3, "f32 serving launching a backward"),
    (0, 15, "serving without K4a+w"),
    (1, 15, "the serving modes without K4a+w"),
    (4, 15, "f32 serving without K4a+w"),
    (0, 10, "serving on K4a alone (the store in its own launch)"),
    (1, 10, "the serving modes on K4a alone"),
    (0, 11, "bf16 serving launching K4w"),
    (1, 11, "the int8 modes without K4w's prefill insert"),
    (2, 15, "training launching K4a+w"),
    (6, 0, "the pipeline without the wgmma forward"),
    (6, 1, "the pipeline on the simple forward"),
    (6, 15, "the pipeline without K4a+w"),
    (6, 10, "the pipeline on K4a alone"),
    (6, 11, "the pipeline without K4w's int8 prefill insert"),
    (6, 4, "the pipeline launching K3"),
    (7, 0, "the front door without the wgmma forward"),
    (7, 15, "the front door without K4a+w"),
    (7, 1, "the front door on the simple forward"),
    (7, 11, "the front door launching K4w on bf16 pages"),
    (8, 1, "the fleet's f32 demo without the simple forward"),
    (8, 15, "the fleet's demo without K4a+w"),
    (8, 0, "the fleet's f32 demo on the wgmma forward"),
    (8, 10, "the fleet's demo on K4a alone"),
    (9, 0, "the network paths launching the wgmma forward"),
    (9, 1, "the network paths launching the simple forward"),
    (9, 9, "the network paths launching the wgmma K3b"),
    (9, 15, "the network paths launching K4a+w"),
    (10, 16, "the recurrent path without K11f"),
    (10, 17, "the recurrent path without K11b"),
    (10, 0, "the recurrent path launching the wgmma forward"),
    (2, 16, "training launching K11f"),
    (9, 17, "the network paths launching K11b"),
    (6, 16, "the pipeline launching K11f"),
    (10, 18, "the recurrent path without K11Lf"),
    (10, 19, "the recurrent path without K11Lb"),
    (10, 17, "the recurrent path launching K11b beside K11L"),
    (11, 16, "the wide layer without K11f"),
    (11, 17, "the wide layer without K11b"),
    (11, 18, "the wide layer launching K11Lf"),
    (11, 0, "the wide layer launching the wgmma forward"),
    (2, 18, "training launching K11Lf"),
    (9, 19, "the network paths launching K11Lb"),
    (7, 18, "the front door launching K11Lf"),
    (12, 0, "the detection path launching the wgmma forward"),
    (12, 1, "the detection path launching the simple forward"),
    (12, 3, "the detection path launching the mma.sync backward"),
    (12, 8, "the detection path launching the wgmma K3f"),
    (12, 15, "the detection path launching K4a+w"),
    (12, 16, "the detection path launching K11f"),
    (12, 19, "the detection path launching K11Lb"),
    (12, 20, "the detection path taking the attention op's plain route")])
def test_path_launch_checks_catch_each_misroute(path, kernel, what):
    paths = _path_launches()
    chip_smoke.check_path_launches(*paths)
    counts = list(paths[path])
    counts[kernel] = 0 if counts[kernel] else 7
    paths[path] = tuple(counts)
    with pytest.raises(AssertionError):
        chip_smoke.check_path_launches(*paths)


_SIMPLE_PTXAS = "".join(
    f"ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__x_22_flash"
    f"_attention_fwd_cu_y16flash_fwd_kernelI{t}Li{w}EEEvNS_4ArgsE' for "
    f"'sm_90a'\nptxas info    : Function properties for _Z\n    0 bytes "
    f"stack frame, {s} bytes spill stores, {s} bytes spill loads\nptxas "
    f"info    : Used {r} registers, used 1 barriers\n"
    for t in ("f", "13__nv_bfloat16") for w in chip_smoke.SIMPLE_WIDTHS
    for r, s in [(215 if (t, w) == ("f", 256) else 96, 0)])


def test_ptxas_report_of_each_simple_forward_instantiation():
    report = chip_smoke.simple_ptxas(_SIMPLE_PTXAS)
    assert sorted(report) == chip_smoke.SIMPLE_INSTANTIATIONS
    assert report["f32 w256"] == {"registers": 215, "spill_bytes": 0}
    assert chip_smoke.spill_free(report, chip_smoke.SIMPLE_INSTANTIATIONS)
    spilled = _SIMPLE_PTXAS.replace("0 bytes spill stores, 0 bytes spill "
                                    "loads\nptxas info    : Used 215",
                                    "4 bytes spill stores, 12 bytes spill "
                                    "loads\nptxas info    : Used 215")
    assert not chip_smoke.spill_free(chip_smoke.simple_ptxas(spilled),
                                     chip_smoke.SIMPLE_INSTANTIATIONS)


@pytest.mark.parametrize("spill", [0, 16])
def test_ptxas_report_of_each_mma_sync_backward_kernel(spill):
    entries = [(k, t, f"Li{w}E") for k in ("dq", "dkdv")
               for t in ("f", "13__nv_bfloat16")
               for w in chip_smoke.SIMPLE_WIDTHS]
    entries += [("delta", t, "") for t in ("f", "13__nv_bfloat16")]
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__x_22_"
        f"flash_attention_bwd_cu_y{len(k) + 7}{k}_kernelI{t}{w}EvNS_4ArgsE' "
        f"for 'sm_90a'\n    0 bytes stack frame, "
        f"{spill if (k, w) == ('dkdv', 'Li256E') else 0} bytes spill "
        f"stores, 0 bytes spill loads\nptxas info    : Used 200 registers\n"
        for k, t, w in entries)
    report = chip_smoke.bwd_ptxas(log)
    assert sorted(report) == chip_smoke.BWD_INSTANTIATIONS
    assert len(report) == 26
    assert chip_smoke.spill_free(report, chip_smoke.BWD_INSTANTIATIONS) \
        is (spill == 0)


def test_cases_hold_the_f32_shapes_and_every_new_head_dim():
    """Both kernels at the table's shape, the f32 model's prefill and its
    training layer; bf16 at d 32, 80, 96 and 256; and d 8, 40, 136 and 256
    (past the old kernels' 16-128) in f32 and bf16."""
    f32 = [("3d", 16, 1, 256, 256, 64, "float32", True),
           ("fused", 1, 16, 1024, 1024, 64, "float32", True),
           ("fused", 8, 16, 1024, 1024, 64, "float32", True)]
    for cases in (chip_smoke.KERNEL_CASES, chip_smoke.BWD_CASES):
        assert all(c in cases for c in f32)
        bf16_d = {c[5] for c in cases if c[6] == "bfloat16"}
        assert {32, 80, 96, 256} <= bf16_d
        for d in (8, 40):
            assert {c[6] for c in cases if c[5] == d} == {"float32",
                                                         "bfloat16"}
        assert {136, 256} <= {c[5] for c in cases if c[6] == "float32"}
        assert all(c[5] in range(8, 257, 8) for c in cases)
    # PR 8's kernels took d % 16 == 0 in [16, 128]: the cases they are timed
    # against in turns are ones they take
    assert all(c[5] % 16 == 0 and 16 <= c[5] <= 128 and not (
        c[6] == "bfloat16" and c[5] in (64, 128))
        for c in chip_smoke.F32_COMPARE_CASES)
    assert chip_smoke.BWD_MAIN_CASE["bwd"] == f32[0]
    assert chip_smoke.MAIN_CASE["simple"] == f32[0]


def test_attention_f64_is_the_plain_versions_in_f64():
    """--precision-f32's truth: o, lse and the three gradients of attention
    in f64, which the plain versions (f32) meet to f32 rounding."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((2, 40, 16), generator=g) for _ in range(4))
    for causal in (True, False):
        o64, lse64, g64 = chip_smoke._attention_f64(torch, q, k, v, do,
                                                    causal)
        assert o64.dtype == lse64.dtype == torch.float64
        o, lse = fa.flash_attention_reference(q, k, v, causal)
        assert (o.double() - o64).abs().max().item() < 1e-5
        assert (lse.double() - lse64).abs().max().item() < 1e-5
        for got, want in zip(fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do, causal), g64):
            assert (got.double() - want).abs().max().item() < 1e-5
    assert chip_smoke.F32_PRECISION_CASES == [
        c for c in chip_smoke.BWD_CASES if c[6] == "float32"
        and c[5] == 64]


def test_flip_gap_reads_the_teacher_forced_row_of_the_differing_token():
    """flip_gap's row is the one that predicts token ``at``: under greedy
    on the CPU (f32) its argmax is the stream's token there, and the gap
    is that logit less the other stream's token's."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import generation as tgen
    from deeplearning4j_tpu_torch.models import transformer as ttr
    cfg = ttr.TransformerConfig(vocab_size=61, n_layers=2, n_heads=2,
                                d_model=32, max_len=64)
    model = ttr.TransformerLM(cfg, device="cpu")
    params = model.init_params(0)
    eng = tgen.DecodeEngine(model, params, max_len=48, device="cpu")
    prompt = np.random.default_rng(5).integers(0, 61, (9,)).astype(np.int32)
    want = eng.generate(prompt[None], 6)[0]
    full = torch.as_tensor(np.concatenate([prompt, want[:-1]])[None])
    with torch.inference_mode():
        rows = model.apply(params, full)[0, prompt.size - 1:].numpy()
    for at in (0, 3):
        other = int(np.argsort(rows[at])[-2])
        got = want.copy()
        got[at] = other
        flip = chip_smoke.flip_gap(torch, model, params, prompt, want, got,
                                   at)
        assert flip["want"] == int(want[at]) == int(rows[at].argmax())
        assert flip["got"] == other
        assert flip["gap"] == pytest.approx(
            float(rows[at][want[at]] - rows[at][other]), abs=1e-5)


def test_cases_hold_a_prefill_in_every_bucket_of_the_fleet_demo():
    """The fleet's workers prefill (and re-prefill adopted sessions) in
    every bucket of the demo engine: K1's simple forward and its backward
    are held to their plain versions at each one."""
    from deeplearning4j_tpu_torch.models.generation import (
        default_prefill_buckets)
    from deeplearning4j_tpu_torch.tools.serve import (DEMO_CONFIG,
                                                      DEMO_MAX_LEN)
    hd = DEMO_CONFIG["d_model"] // DEMO_CONFIG["n_heads"]
    for t in default_prefill_buckets(DEMO_MAX_LEN):
        case = ("fused", 1, DEMO_CONFIG["n_heads"], t, t, hd, "float32",
                True)
        assert case in chip_smoke.KERNEL_CASES
        assert case in chip_smoke.BWD_CASES


def test_kernel_counters_are_named_in_all_kernels_order():
    """The package's counter table names every kernel chip_smoke reports,
    in ALL_KERNELS' order, and ``reset_launch_counts`` zeroes them."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    assert tuple(kernels.COUNTERS) == chip_smoke.ALL_KERNELS
    saved = kernels.launch_counts()
    try:
        pa.launches_attend_write = 7
        assert kernels.launch_counts()["paged_attention_write"] == 7
        kernels.reset_launch_counts()
        assert set(kernels.launch_counts().values()) == {0}
    finally:
        for name, (mod, attr) in kernels.COUNTERS.items():
            setattr(kernels._module(mod), attr, saved[name])


def test_worker_writes_its_launch_counts_by_name(tmp_path):
    """What a stopped worker leaves for the fleet drill: the process's
    counters by kernel name, whole (no temporary file left)."""
    import json
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.tools import serve
    saved = fa.launches_simple
    try:
        fa.launches_simple = 3
        serve._write_launch_counts(str(tmp_path), "w0")
    finally:
        fa.launches_simple = saved
    doc = json.loads((tmp_path / "w0.json").read_text())
    assert list(doc) == list(kernels.COUNTERS) and doc["simple"] == 3
    assert [p.name for p in tmp_path.iterdir()] == ["w0.json"]


@pytest.mark.parametrize("inflight, live, adopted, ok", [
    ([10, 9, 8, 3], 4, 4, True),
    ([16, 9, 8, 3], 4, 4, False),      # a stream ended before the kill
    ([10, 9, 8, 3], 0, 0, False),      # the killed worker owned nothing
    ([10, 9, 8, 3], 4, 3, False),      # one orphan left unadopted
])
def test_check_drill_needs_streams_in_flight_and_every_orphan_adopted(
        inflight, live, adopted, ok):
    rec = {"inflight_at_kill": [min(n, chip_smoke.FLEET_NEW)
                                for n in inflight],
           "victim_live_at_kill": live, "adopted_by_survivor": adopted}
    if ok:
        chip_smoke.check_drill(rec)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_drill(rec)


def test_baseline_gaps_read_each_tokens_top2_margin():
    """On the CPU (f32) the teacher-forced rows of a greedy stream pick
    its tokens, every margin is positive, and another length of the same
    rows moves a logit by f32 rounding only."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.tools.serve import demo_engine
    eng = demo_engine("cpu")
    prompts = [[5, 2, 9, 7], [3, 3, 8, 1, 4, 6]]
    streams = [eng.generate(np.asarray(p, np.int32)[None], 6)[0].tolist()
               for p in prompts]
    got = chip_smoke.baseline_gaps(torch, eng.model, eng.params, prompts,
                                   streams)
    assert got["tokens"] == 12 and got["min"] > 0
    assert 0 <= got["at_most_tol"] <= got["tokens"]
    assert got["max_logit_shift"] < 1e-4


def test_network_phase_uses_resnet_bench_s_config():
    """benchmarks/resnet_bench.py's ResNet-50: 224x224x3, 1000 classes,
    batch 32, Nesterovs(0.1, 0.9); seeded N(0, 1) images, one-hot labels."""
    assert (chip_smoke.NET_SHAPE, chip_smoke.NET_CLASSES,
            chip_smoke.NET_BATCH) == ((224, 224, 3), 1000, 32)
    conf = chip_smoke.zoo_resnet("bfloat16").conf()
    assert conf.updater.to_dict() == {"learning_rate": 0.1, "momentum": 0.9,
                                      "@updater": "Nesterovs"}
    assert conf.dtype == "bfloat16"
    x, y = chip_smoke.network_data(3, shape=(4, 4, 3), classes=5, seed=1)
    x2, y2 = chip_smoke.network_data(3, shape=(4, 4, 3), classes=5, seed=1)
    assert x.dtype == np.float32 and x.shape == (3, 4, 4, 3)
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    assert (y.sum(-1) == 1).all() and y.shape == (3, 5)


def test_tree_errors_read_each_leaf_and_each_displacement():
    want = {"a": {"W": np.ones((2, 2)), "b": np.zeros(2) + 2}}
    got = {"a": {"W": np.ones((2, 2)) * 1.1, "b": np.zeros(2) + 2}}
    errs = chip_smoke.tree_errors(got, want)
    assert abs(errs["a/W"] - 0.1) < 1e-12 and errs["a/b"] == 0
    assert chip_smoke.worst(errs) == (errs["a/W"], "a/W")
    base = {"a": {"W": np.ones((2, 2)) * 0.9, "b": np.zeros(2) + 1}}
    d = chip_smoke.tree_errors(got, want, base=base)
    # displacements 0.2 against 0.1: off by 1 relative
    assert abs(d["a/W"] - 1.0) < 1e-12 and d["a/b"] == 0


def _held_step_case(n=10_000, flip=7):
    """Two sides of an Adam first step (lr 1, eps 1e-8) over one leaf of
    ``n`` elements, every gradient 1 but ``got``'s step applied -1 at
    ``flip``, a second backward pass that rounded that element otherwise
    than the first."""
    base = {"a": {"W": np.zeros(n)}}
    g = np.ones(n)
    applied = g.copy()
    applied[flip] = -1.0
    step = lambda grad: {"a": {"W": -grad / (np.abs(grad) + 1e-8)}}
    want = {"grads": {"a": {"W": g}}, "step_grads": {"a": {"W": g}},
            "params": step(g)}
    got = {"grads": {"a": {"W": g.copy()}},
           "step_grads": {"a": {"W": applied}}, "params": step(applied)}
    return got, want, base


def test_held_step_is_masked_by_the_gradients_the_step_applied():
    """One element of opposite sign in a leaf of n reads 2 / √n alone: a
    mask from another backward pass (the computed gradients) keeps it,
    the mask from the step's own leaves it out."""
    n = 10_000
    got, want, base = _held_step_case(n)
    errs, left = chip_smoke.agreed_step_errors(got, want, base, 1e-8)
    assert errs["a/W"] < 1e-12 and left == pytest.approx(1 / n)
    stale = {**got, "step_grads": got["grads"]}
    errs, left = chip_smoke.agreed_step_errors(stale, want, base, 1e-8)
    assert errs["a/W"] == pytest.approx(2 / np.sqrt(n)) and left == 0


def test_zoo_run_records_the_gradients_its_step_applied():
    """``zoo_run``'s "step_grads" are what ``fit`` applied: on the CPU
    the computed gradients to the bit (the same dropout masks), and
    Adam's first step lr·g / (|g| + eps) over them; the net keeps no
    wrapper."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    net = zoo.UNet(num_classes=1, input_shape=(16, 16, 3),
                   data_type="float32").init_model(device="cpu")
    before = tree_to_numpy(net.param_tree())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    y = (rng.uniform(size=(2, 16, 16, 1)) < 0.5).astype(np.float32)
    with chip_smoke.shared_dropout():
        out = chip_smoke.zoo_run(net, x, y)
    assert "_value_and_grad" not in vars(net)
    u = net.conf.updater
    lr, eps = float(u.learning_rate), float(u.epsilon)
    for k in out["grads"]:
        for p, g in out["grads"][k].items():
            applied = out["step_grads"][k][p]
            assert np.array_equal(applied, g)
            moved = out["params"][k][p] - before[k][p]
            np.testing.assert_allclose(
                moved, -lr * applied / (np.abs(applied) + eps),
                rtol=1e-3, atol=1e-6)


def test_rows_failed_names_each_row_read_above_and_nan():
    rows = {"loss": 1e-4, "grad": 0.2}
    assert chip_smoke.rows_failed({"loss": 5e-5, "grad": 0.1}, rows) == []
    assert chip_smoke.rows_failed({"loss": 2e-4, "grad": 0.1}, rows) == [
        "loss"]
    assert chip_smoke.rows_failed({"loss": float("nan"), "grad": 0.9},
                                  rows) == ["grad", "loss"]


def test_network_rows_part_f32_from_the_tf32_readings():
    """The f32 rows sit above f32's CPU readings against f64 and below
    TF32's (PERF.md), so the TF32 control fails them."""
    f32 = {"probs": 2.9e-5, "loss": 8.8e-6, "grad": 0.032, "step": 0.032,
           "state": 2.9e-5}
    tf32 = {"probs": 3.0e-2, "loss": 1.9e-4, "grad": 0.88, "step": 0.88,
            "state": 3.0e-2}
    rows = chip_smoke.TOL_NET_F32
    assert chip_smoke.rows_failed(f32, rows) == []
    assert chip_smoke.rows_failed(tf32, rows) == sorted(rows)


def test_floors_failed_names_each_floor_not_read_above_and_nan():
    floors = {"probs": 1e-3, "loss": 1e-4}
    assert chip_smoke.floors_failed({"probs": 0.1, "loss": 0.03},
                                    floors) == []
    assert chip_smoke.floors_failed({"probs": 2.6e-5, "loss": 0.03},
                                    floors) == ["probs"]
    assert chip_smoke.floors_failed({"probs": float("nan"), "loss": 1e-4},
                                    floors) == ["loss", "probs"]


def test_bf16_floors_part_bf16_from_f32():
    """(b)'s floors sit above what two f32 runs read (the CPU against
    f64, PERF.md) and below bf16's readings, so a bf16 policy that
    computed in f32 fails them."""
    floors = chip_smoke.FLOOR_NET_BF16
    f32 = {"probs": 2.9e-5, "loss": 8.8e-6}
    bf16 = {"probs": 0.115, "loss": 0.071, "head_grad": 0.098}
    assert chip_smoke.floors_failed(f32, floors) == sorted(floors)
    assert chip_smoke.floors_failed(bf16, floors) == []
    assert chip_smoke.rows_failed(bf16, chip_smoke.TOL_NET_BF16) == []


@pytest.fixture(scope="module")
def bn_cases():
    import torch
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    net = ResNet50(num_classes=10, input_shape=(32, 32, 3)).init_model(
        device="cpu")
    # batch 8: at least 8 values a channel (1x1 at the last stage; at 2,
    # two values normalize to ±1 whatever the route, and the folded
    # apply's cancellation shows)
    return chip_smoke.bn_route_inputs(torch, net, 8, torch.float32,
                                      torch.device("cpu"))


def test_bn_route_inputs_cover_every_batchnorm_at_its_shape(bn_cases):
    assert len(bn_cases) == 53
    layer, x, g, b, state, dy = bn_cases[0]
    assert x.shape == dy.shape and x.shape[-1] == g.shape[0] == layer.n_out
    assert x.requires_grad and g.requires_grad and b.requires_grad
    assert {c[1].shape[1] for c in bn_cases} == {16, 8, 4, 2, 1}


def test_bn_library_routes_agree_with_the_port_and_see_unbiased_var(
        bn_cases):
    """The native route (with its running update from the saved inverse
    std) and the dispatcher's route compute the port's BatchNormalization
    on the CPU; a running update from the unbiased variance does not."""
    import torch
    native = chip_smoke.bn_route_agreement(
        torch, lambda *a: chip_smoke.bn_native(torch, *a), bn_cases)
    assert sorted(native) == ["dbeta", "dgamma", "dx", "mean", "out", "var"]
    assert max(native.values()) < 1e-5, native
    disp = chip_smoke.bn_route_agreement(
        torch, lambda *a: chip_smoke.bn_dispatch(torch, *a), bn_cases)
    assert sorted(disp) == ["dbeta", "dgamma", "dx", "out"]
    assert max(disp.values()) < 1e-5, disp

    def unbiased(layer, x, g, b, state):
        out, new = chip_smoke.bn_native(torch, layer, x, g, b, state)
        n = x.numel() // x.shape[-1]
        var = x.detach().reshape(n, -1).var(0, unbiased=True)
        return out, {"mean": new["mean"],
                     "var": layer.decay * state["var"]
                     + (1 - layer.decay) * var}
    wrong = chip_smoke.bn_route_agreement(torch, unbiased, bn_cases)
    assert wrong["var"] > 1e-3 and wrong["out"] < 1e-5


def test_plain_resnet50_has_the_port_s_parameters():
    import torch
    twin = chip_smoke.plain_resnet50(torch, classes=1000)
    assert sum(p.numel() for p in twin.parameters()) == 25_557_032
    convs = [m for m in twin.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 53 and all(m.bias is None for m in convs)


def test_network_phase_flop_count_is_741_gflop_a_step():
    """The FLOPs the phase divides by (``step_cost``): 3 × 2 × the
    multiply-adds of ResNet-50 at 224² (3.86e9 an image) × batch 32."""
    net = chip_smoke.zoo_resnet("float32").init_model(device="cpu")
    flops = net.step_cost(chip_smoke.NET_BATCH)[0]
    assert flops == 3 * net._forward_flops(chip_smoke.NET_BATCH)
    assert abs(flops / 741e9 - 1) < 0.002


# ------------------------------------------------------ the recurrent phase
def test_char_stream_is_seeded_one_hot_and_shifted():
    x, y = chip_smoke.char_stream(4, 30)
    x2, y2 = chip_smoke.char_stream(4, 30)
    assert x.shape == y.shape == (4, 30, chip_smoke.RNN_CHARS)
    assert (x == x2).all() and (y == y2).all()
    assert (x.sum(-1) == 1).all() and (y.sum(-1) == 1).all()
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])


def test_k11_bound_counts_every_operand_once():
    """K11f at R1's cell with no mask: z (N, 4H), b (4H), c_prev and h_prev
    read, h, c and the gates (N, 4H) written (the output is h), f32, over
    3.35 TB/s; under a mask it also reads the mask (N) and writes y. K11b
    reads dy, dh, dc, the gates, c and c_prev (no bias) and writes dz and
    dc_prev, and under a mask reads the mask and writes dh_pass; the
    peepholes add their (3, H) and, in the backward, the (3, N, H) sums
    read and written."""
    nh = 32 * 256
    ms, by = chip_smoke.k11_bound_ms(32, 256, False, False, "fwd")
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (4 * 12 * nh + 16 * 256) / 3.35e12)
    ms, _ = chip_smoke.k11_bound_ms(32, 256, True, True, "fwd")
    want = 4 * 13 * nh + 16 * 256 + 12 * 256 + 4 * 32
    assert ms == pytest.approx(1e3 * want / 3.35e12)
    ms, _ = chip_smoke.k11_bound_ms(32, 256, False, False, "bwd")
    assert ms == pytest.approx(1e3 * 4 * 14 * nh / 3.35e12)
    ms, _ = chip_smoke.k11_bound_ms(32, 256, True, True, "bwd")
    want = 4 * 15 * nh + 12 * 256 + 4 * 32 + 24 * nh
    assert ms == pytest.approx(1e3 * want / 3.35e12)


def test_tbptt_report_reads_zero_against_itself():
    rec = {"losses": [1.0, 2.0], "params": {"0": {"W": np.ones((2, 2))}},
           "carries": {"0": [np.ones(3), np.ones(3)]}}
    base = {"0": {"W": np.zeros((2, 2))}}
    rep = chip_smoke.tbptt_report(rec, rec, base)
    assert rep["loss"] == rep["step"] == rep["carry"] == 0.0
    other = dict(rec, losses=[1.0, 2.5])
    assert chip_smoke.tbptt_report(other, rec, base)["loss"] == 0.5


def test_r3_graph_takes_r1_weights_and_fits_alike():
    """R3 (R1's layers as a ComputationGraph) loads R1's trees as they are
    and runs the same TBPTT chunks: equal chunk losses on the CPU."""
    r1 = chip_smoke.rnn_net("R1", "cpu")
    r3 = chip_smoke.r3_graph("cpu")
    assert r3.param_tree().keys() == r1.param_tree().keys()
    chip_smoke.carry_net(r1, r3)
    x, y = chip_smoke.char_stream(2, 2 * chip_smoke.RNN_TBPTT)
    a = chip_smoke.tbptt_fit_record(r1, x, y)
    b = chip_smoke.tbptt_fit_record(r3, x, y)
    assert len(a["losses"]) == len(b["losses"]) == 2
    np.testing.assert_allclose(a["losses"], b["losses"], atol=1e-5)
    assert sorted(a["carries"]) == sorted(b["carries"]) == ["0", "1"]


def test_rnn_readings_hold_f32_near_f64_on_the_cpu():
    """The CPU readings behind (a)'s rows, on a 2-chunk sequence: R2's f32
    fit against the same fit in f64 reads at f32's level, far under the
    rows (which sit over the full-length readings)."""
    got = chip_smoke.rnn_readings("R2", seq=2 * chip_smoke.RNN_TBPTT)
    assert set(got) >= {"loss", "step", "carry", "probs"}
    assert 0 < got["probs"] < chip_smoke.TOL_RNN_F32["probs"]
    assert got["loss"] < chip_smoke.TOL_RNN_F32["loss"]
    assert got["step"] < chip_smoke.TOL_RNN_F32["step"]
    assert got["carry"] < chip_smoke.TOL_RNN_F32["carry"]


def test_k11l_bound_counts_the_product_and_every_operand_once():
    """K11Lf at R1's second layer (N 32, T 50, H 256), no mask: the
    recurrent product 2·N·T·H·4H = 0.839 GFLOP at 67 TFLOP/s (12.5 µs)
    against X·W, RW, b, h0 and c0 read and h, c and the gates of every
    step written (17.6 MB, 5.2 µs): bound by operations; K11Lb the same
    product against dy, the gates, c of every step, dh, dc, c0 and RW read
    and dz, dh0 and dc0 written."""
    n, t, hd = 32, 50, 256
    flops = 2 * n * t * hd * 4 * hd
    ms, by = chip_smoke.k11l_bound_ms(n, hd, False, False, "fwd")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flops / 67e12)
    assert ms == pytest.approx(0.0125, rel=2e-2)
    tnh, nh = t * n * hd, n * hd
    fwd_bytes = 4 * (4 * tnh + 4 * hd * hd + 4 * hd + 2 * nh + 6 * tnh)
    bwd_bytes = 4 * (6 * tnh + 3 * nh + 4 * hd * hd + 4 * tnh + 2 * nh)
    assert fwd_bytes / 3.35e12 < flops / 67e12
    assert chip_smoke.k11l_bound_ms(n, hd, False, False, "bwd") == (
        pytest.approx(1e3 * max(flops / 67e12, bwd_bytes / 3.35e12)),
        "operations")
    # at one step and one row the bytes bound it
    ms1, by1 = chip_smoke.k11l_bound_ms(1, 256, True, True, "fwd", t_len=1)
    assert by1 == "bytes"
    want = 4 * (4 * 256 + 4 * 256 * 256 + 4 * 256 + 2 * 256 + 6 * 256
                + 256 + 3 * 256 + 1)
    assert ms1 == pytest.approx(1e3 * want / 3.35e12)


def test_k11l_readings_sit_under_the_rows_on_the_cpu():
    """The CPU readings behind TOL_K11L, on two of its cases and one
    draw: the plain layer in f32 against f64 over a chunk reads at f32's
    level, at least 4× under the rows."""
    got = chip_smoke.k11l_readings(
        cases=[chip_smoke.K11L_MAIN_CASE, (32, 200, True, True)], seeds=[0])
    for which in ("fwd", "bwd"):
        assert 0 < got[which] <= chip_smoke.TOL_K11L[which] / 4


def test_k11l_inputs_mask_cuts_gaps_and_zero_rows():
    import torch
    ops, dy, dh, dc = chip_smoke.k11l_inputs(torch, (32, 8, True, True),
                                             "cpu")
    m = ops["m"]
    assert m.shape == (chip_smoke.RNN_TBPTT, 32) and m.is_contiguous()
    # every row keeps its first 20 steps but row 2 (none) and row 1's
    # gap (steps 10-15)
    assert not m[:, 2].any() and not m[10:16, 1].any()
    assert m[:20].sum() == 20 * 31 - 6
    assert ops["peep"].shape == (3, 8) and dy.shape == (50, 32, 8)
    plain, _, _, _ = chip_smoke.k11l_inputs(torch, (4, 8, False, False),
                                            "cpu")
    assert plain["m"] is None and plain["peep"] is None


_LAYER_PTXAS = "".join(
    f"ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__x_11_rnn_"
    f"cell_cu_x{name}' for 'sm_90a'\n"
    f"    16 bytes stack frame, {spill} bytes spill stores, 0 bytes spill "
    f"loads\nptxas info    : Used {regs} registers, used 1 barriers\n"
    for name, spill, regs in (
        ("21lstm_layer_fwd_kernelILi4EEEvPKf", 0, 109),
        ("21lstm_layer_bwd_kernelILi4EEEvPKf", 0, 98),
        ("21lstm_layer_fwd_kernelILi2EEEvPKf", 0, 75),
        ("21lstm_layer_bwd_kernelILi2EEEvPKf", 0, 76),
        ("21lstm_layer_fwd_kernelILi1EEEvPKf", 0, 65),
        ("21lstm_layer_bwd_kernelILi1EEEvPKf", 8, 64),
        ("15lstm_fwd_kernelEPKf", 0, 32), ("15lstm_bwd_kernelEPKf", 0, 32)))


def test_rnn_cell_ptxas_reads_every_k11_and_k11l_kernel():
    report = chip_smoke.rnn_cell_ptxas(_LAYER_PTXAS)
    assert sorted(report) == sorted(chip_smoke.RNN_CELL_INSTANTIATIONS)
    assert report["layer_fwd r4"] == {"spill_bytes": 0, "registers": 109}
    assert report["fwd"]["registers"] == 32
    assert not chip_smoke.spill_free(report,
                                     chip_smoke.RNN_CELL_INSTANTIATIONS)
    report["layer_bwd r1"]["spill_bytes"] = 0
    assert chip_smoke.spill_free(report, chip_smoke.RNN_CELL_INSTANTIATIONS)


def test_recurrent_kernel_entries_take_each_kernel_from_its_path():
    """K11f/K11b report the wide layer's launches (their path since K11L
    runs R1), K11Lf/K11Lb the R1 fit's; every entry has the contract's
    keys, K11L's library the cuDNN layer (forward, forward + backward)."""
    row = lambda p: {"max_abs_err": {"fwd": 1e-7, "bwd": 2e-7},
                     "fwd_ms": 0.1, "fwd_device_ms": 0.05, "bwd_ms": 0.2,
                     "bwd_device_ms": 0.06, "fwd_plain_ms": 3.0,
                     "bwd_plain_ms": 4.0, "fwd_bound_ms": 0.0125,
                     "bwd_bound_ms": 0.0125, "fwd_bound_by": "operations",
                     "bwd_bound_by": "operations", "case": {"h": 256},
                     "library": p, "library_ms": 0.3,
                     "library_device_ms": 0.2, "library_bwd_ms": 0.4,
                     "library_bwd_device_ms": 0.01,
                     "library_fwd_bwd_ms": 0.9,
                     "library_fwd_bwd_device_ms": 0.7}
    k11 = {chip_smoke.K11_MAIN_CASE: row("aten")}
    k11l = {chip_smoke.K11L_MAIN_CASE: row("cudnn")}
    names = chip_smoke.ALL_KERNELS
    launches = {k: {"recurrent": 40 * (k.startswith("rnn_layer")),
                    "wide_layer": 50 * (k.startswith("rnn_cell"))}
                for k in names}
    got = chip_smoke.recurrent_kernel_entries(launches, k11, k11l)
    assert [e["name"] for e in got] == ["lstm_cell_fwd", "lstm_cell_bwd",
                                        "lstm_layer_fwd", "lstm_layer_bwd"]
    assert [e["launches"] for e in got] == [50, 50, 40, 40]
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    assert all(keys <= set(e) and e["route"] == "cuda" for e in got)
    assert got[2]["replaces"].endswith("layers.py:895")
    assert (got[2]["library_ms"], got[3]["library_ms"]) == (0.3, 0.9)
    assert got[3]["max_abs_err"] == 2e-7


# ------------------------------------------------------- the attention slice
@pytest.mark.parametrize("kind", ["a1", "gap", "none"])
def test_attention_cases_keep_a_key_in_every_row(kind):
    """The kernels' masked cases hand over rows that each keep a key (a row
    with none is the op's to avoid); "gap" masks the first tile and an
    interior run; "empty" leaves one element with no key, which the phase
    hands over as the op does."""
    for _name, b, _h, _tq, t_k, _d, _dt, k in chip_smoke.MASKED_CASES:
        m = chip_smoke.key_mask_np(k, b, t_k)
        if m is None:
            continue
        assert m.shape == (b, t_k)
        if k == "empty":
            assert not m[1].any() and m[[0, 2, 3]].any(axis=1).all()
        else:
            assert m.any(axis=1).all()
    m = chip_smoke.key_mask_np(kind, 4, 700)
    if kind == "gap":
        assert not m[0, :64].any() and not m[1, 175:350].any()
    if kind == "a1":
        assert (m.sum(axis=1) >= chip_smoke.A1_MIN_LEN).all()
    if kind == "none":
        assert m is None


def test_masked_bound_counts_the_pairs_the_mask_keeps():
    m = np.zeros((2, 256), bool)
    m[0, :100] = True
    m[1, :28] = True
    ms, by = chip_smoke.masked_bound_ms(m, 16, 256, 256, 64, "bfloat16")
    flops = 4.0 * 16 * 64 * 256 * 128
    nbytes = 2 * 2 * 16 * 64 * 2 * 512 + 4 * 2 * 16 * 256 + 2 * 256
    assert (ms, by) == chip_smoke._bound(flops, nbytes, "bfloat16",
                                         chip_smoke.ATTN_PEAK_FLOPS)
    ms_b, _ = chip_smoke.masked_bound_ms(m, 16, 256, 256, 64, "bfloat16",
                                         backward=True)
    assert ms_b >= ms


def test_shared_dropout_draws_one_mask_for_both_devices():
    """Under ``shared_dropout`` a mask depends on its shape alone (the CPU
    and card nets of check (a) drop the same units); the port's own
    dropout comes back after it."""
    import torch
    from deeplearning4j_tpu_torch.ops import standard
    plain = standard.dropout_inverted
    x = torch.ones((4, 64))
    with chip_smoke.shared_dropout():
        a = standard.dropout_inverted(x, None, p=0.5)
        b = standard.dropout_inverted(x * 3, torch.Generator(), p=0.5)
    assert standard.dropout_inverted is plain
    assert torch.equal(a != 0, b != 0) and set(a.unique().tolist()) <= {0, 2}


def test_attention_nets_are_the_slice_s_widths():
    """A1 at the large config's widths; A2 and the zoo twins' parameter
    counts those of the port's nets; the output layer's key of each net."""
    import torch
    conf = chip_smoke.a1_conf("bfloat16")
    emb, att1, att2, pool, out = conf.layers
    assert (emb.n_in, emb.n_out) == (32768, 1024)
    for att in (att1, att2):
        assert (att.n_heads, att.head_size, att.n_in) == (16, 64, 1024)
    assert out.n_out == chip_smoke.A1_CLASSES
    for name in ("VGG16", "VGG19"):
        twin = chip_smoke.plain_vgg(torch, name)
        conf = chip_smoke.zoo_model(name, "float32").conf()
        assert sum(p.numel() for p in twin.parameters()) == sum(
            layer.n_params() for layer in conf.layers)
    twin = chip_smoke.plain_darknet19(torch)
    conf = chip_smoke.zoo_model("Darknet19", "float32").conf()
    assert sum(p.numel() for p in twin.parameters()) == sum(
        n.layer.n_params() for n in conf.nodes.values() if n.layer)
    graph, mln = chip_smoke.a2_nets("cpu")
    assert chip_smoke.head_key(graph) == "out"
    assert chip_smoke.head_key(mln) == "3"


_MASKED_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_iii7OutArgsiiifiPKhx' for 'sm_90a'
    0 bytes stack frame, {s} bytes spill stores, {s} bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILi128ELb0EEEv14CUtensorMap_stS1_S1_iii7OutArgsiiifiPKhx' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_bwd_wgmma_kernelILi64ELb0ELb1EEEv14CUtensorMap_stS1_S1_S1_iiiiNS_7BwdArgsE' for 'sm_90a'
    0 bytes stack frame, {s} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_bwd_wgmma_kernelILi64ELb1ELb0EEEv14CUtensorMap_stS1_S1_S1_iiiiNS_7BwdArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


@pytest.mark.parametrize("spill", [0, 92])
def test_ptxas_report_names_the_key_masked_instantiations(spill):
    """Since the key mask is a template parameter, the masked wgmma
    kernels read apart from the unmasked ones (their spills too), and the
    eight backward and four forward instantiations are what the script
    holds to the budget."""
    fwd = chip_smoke.wgmma_ptxas(_MASKED_PTXAS.format(s=spill))
    assert fwd == {"128 masked": {"registers": 168,
                                  "spill_bytes": 2 * spill},
                   128: {"registers": 168, "spill_bytes": 0}}
    bwd = chip_smoke.bwd_wgmma_ptxas(_MASKED_PTXAS.format(s=spill))
    assert bwd == {"d64 dq masked": {"registers": 168, "spill_bytes": spill},
                   "d64 dkdv": {"registers": 168, "spill_bytes": 0}}
    assert set(fwd) <= set(chip_smoke.WGMMA_INSTANTIATIONS)
    assert set(bwd) <= set(chip_smoke.BWD_WGMMA_INSTANTIATIONS)
    assert len(chip_smoke.BWD_WGMMA_INSTANTIATIONS) == 8


def test_ptxas_report_of_the_key_masked_mma_sync_kernels():
    """The simple forward's and the mma.sync / FMA backward's key-masked
    instantiations (a template parameter) read apart from the unmasked
    ones; the D pass has none; the full report is the two lists."""
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__x_22_"
        f"flash_attention_bwd_cu_y{len(k) + 7}{k}_kernelI{t}Li{w}ELb{m}EEv"
        f"NS_4ArgsE' for 'sm_90a'\n    0 bytes stack frame, "
        f"{48 if (k, t, w, m) == ('dkdv', '13__nv_bfloat16', 128, 1) else 0}"
        f" bytes spill stores, 0 bytes spill loads\nptxas info    : Used "
        f"255 registers\n"
        for k in ("dq", "dkdv") for t in ("f", "13__nv_bfloat16")
        for w in chip_smoke.SIMPLE_WIDTHS for m in (0, 1))
    log += "".join(
        f"ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__x_22_"
        f"flash_attention_bwd_cu_y12delta_kernelI{t}EvNS_9DeltaArgsE' for "
        f"'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
        f"spill loads\nptxas info    : Used 36 registers\n"
        for t in ("f", "13__nv_bfloat16"))
    report = chip_smoke.bwd_ptxas(log)
    want = chip_smoke.BWD_INSTANTIATIONS + chip_smoke.BWD_MASKED_INSTANTIATIONS
    assert sorted(report) == sorted(want) and len(report) == 50
    assert report["dkdv bf16 w128 masked"]["spill_bytes"] == 48
    assert report["dkdv bf16 w128"]["spill_bytes"] == 0
    assert not chip_smoke.spill_free(report, want)
    fwd = chip_smoke.simple_ptxas(
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__x_22_"
        "flash_attention_fwd_cu_y16flash_fwd_kernelIfLi256ELb1EEEvNS_4ArgsE'"
        " for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 "
        "bytes spill loads\nptxas info    : Used 252 registers\n")
    assert fwd == {"f32 w256 masked": {"registers": 252, "spill_bytes": 0}}
    assert "f32 w256 masked" in chip_smoke.SIMPLE_MASKED_INSTANTIATIONS


# --------------------------------------------------------- detection
def test_detection_data_holds_one_to_three_boxes_an_image():
    x, y = chip_smoke.detection_data(6, (96, 128, 3), 5, seed=2)
    assert x.shape == (6, 96, 128, 3) and y.shape == (6, 3, 4, 9)
    obj = y[..., 4:].sum(-1)
    assert set(np.unique(obj)) <= {0.0, 1.0}
    per_image = obj.reshape(6, -1).sum(-1)
    assert per_image.min() >= 1 and per_image.max() <= 3
    box = y[obj > 0][:, :4]
    sides = box[:, 2:] - box[:, :2]
    assert (sides >= 0.5).all() and (sides <= 6.0).all()
    centre = 0.5 * (box[:, :2] + box[:, 2:])
    cells = np.stack(np.nonzero(obj), -1)[:, 1:]
    assert (np.floor(centre[:, ::-1]) == cells).all()
    x2, y2 = chip_smoke.detection_data(6, (96, 128, 3), 5, seed=2)
    assert np.array_equal(x, x2) and np.array_equal(y, y2)


def test_plain_yolo_loss_is_the_layer_loss():
    """The twin's plainly written loss equals Yolo2OutputLayer's on the
    same activations and labels."""
    import torch
    from deeplearning4j_tpu_torch.models.zoo.darknet import _YOLO2_PRIORS
    from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
    _, y = chip_smoke.detection_data(4, (160, 160, 3), 20, seed=3)
    out = torch.randn(4, 5, 5, 125, generator=torch.Generator()
                      .manual_seed(0))
    want = Yolo2OutputLayer(boxes=_YOLO2_PRIORS).loss({}, out,
                                                      torch.tensor(y))
    got = chip_smoke.plain_yolo_loss(torch, out, torch.tensor(y),
                                     _YOLO2_PRIORS)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("name,twin", [("YOLO2", "plain_yolo2"),
                                       ("Xception", "plain_xception")])
def test_plain_twins_have_the_port_s_parameters(name, twin):
    import torch
    from deeplearning4j_tpu_torch.models import zoo
    conf = getattr(zoo, name)().conf()
    want = sum(n.layer.n_params() for n in conf.nodes.values()
               if n.layer is not None)
    model = getattr(chip_smoke, twin)(torch)
    assert sum(p.numel() for p in model.parameters()) == want


def test_zoo_data_sizes_each_model_at_its_input():
    for name, (shape, classes) in chip_smoke.ZOO_INPUT.items():
        if name in ("UNet", "YOLO2", "TinyYOLO"):
            continue
        model = chip_smoke.zoo_model(name, "float32")
        assert model.input_shape == shape and model.num_classes == classes
    x, y = chip_smoke.zoo_data("UNet", 2)
    assert x.shape == (2, 512, 512, 3) and y.shape == (2, 512, 512, 1)
    assert set(np.unique(y)) == {0.0, 1.0}
    assert chip_smoke.zoo_model("VGG16", "float32").input_shape == (224, 224,
                                                                    3)


# ----------------------------------------------------------------- transfer
def test_transfer_phase_runs_resnet50_at_full_size():
    assert chip_smoke.NET_SHAPE == (224, 224, 3)
    assert chip_smoke.NET_BATCH == 32 and chip_smoke.NET_CLASSES == 1000
    assert (chip_smoke.TR_TRAIN_BATCHES, chip_smoke.TR_HELD_BATCHES) == (8, 2)
    assert (chip_smoke.TR_PATIENCE, chip_smoke.TR_MAX_EPOCHS) == (2, 4)
    assert chip_smoke.TOL_TRANSFER["cpu_probs"] == \
        chip_smoke.TOL_NET_F32["probs"]


def test_transfer_data_is_seeded_and_one_hot_over_the_head(monkeypatch):
    monkeypatch.setattr(chip_smoke, "NET_SHAPE", (16, 16, 3))
    x, y = chip_smoke.transfer_data(12, 3)
    x2, y2 = chip_smoke.transfer_data(12, 3)
    assert x.shape == (12, 16, 16, 3) and x.dtype == np.float32
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(y, y2)
    assert 0.0 <= x.min() and x.max() <= 255.0
    assert y.shape == (12, chip_smoke.NET_CLASSES)
    assert (y.sum(1) == 1).all()
    assert set(np.nonzero(y)[1]) <= set(range(chip_smoke.TR_CLASSES))


def _small_net():
    from deeplearning4j_tpu_torch.nn.conf import configuration as cfg
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    conf = (cfg.NeuralNetConfiguration.builder().seed(1).updater(Adam(0.1))
            .list().layer(L.DenseLayer(n_in=3, n_out=4, activation="tanh"))
            .layer(L.DenseLayer(n_in=4, n_out=4, activation="tanh"))
            .layer(L.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                 loss_function="mcxent")).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_leaf_comparisons_see_one_changed_bit():
    import torch
    a, b = _small_net(), _small_net()
    assert chip_smoke.unequal_leaves(torch, a.param_tree(),
                                     b.param_tree()) == []
    assert chip_smoke.unequal_updater_leaves(
        torch, a.updater_state(), b.updater_state()) == []
    w = b.param_tree()["1"]["W"]
    w.view(-1)[3] = torch.nextafter(w.view(-1)[3], torch.tensor(9.0))
    assert chip_smoke.unequal_leaves(torch, a.param_tree(),
                                     b.param_tree()) == ["1/W"]
    assert chip_smoke.unequal_leaves(torch, a.param_tree(),
                                     {"0": {}}) != []
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1, 1]]
    b.fit(x, y)
    bad = chip_smoke.unequal_updater_leaves(torch, a.updater_state(),
                                            b.updater_state())
    assert bad and 0 in bad                # the count, then mu and nu
    assert chip_smoke.tree_max_abs(
        torch, chip_smoke.net_snapshot(a), chip_smoke.net_snapshot(a)) == 0.0
    assert chip_smoke.tree_max_abs(
        torch, chip_smoke.net_snapshot(a), chip_smoke.net_snapshot(b)) > 0.0


def test_frozen_updater_leaves_are_the_frozen_layers_mu_and_nu():
    net = _small_net()
    net._frozen = {"0"}
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1, 1]]
    net.fit(x, y)
    frozen = chip_smoke.frozen_updater_leaves(net)
    assert len(frozen) == 4                 # W and b, mu and nu
    assert all(float(t.abs().sum()) == 0 for t in frozen)
    net._frozen = {"1"}
    assert all(float(t.abs().sum()) > 0
               for t in chip_smoke.frozen_updater_leaves(net))


def test_solver_gaps_and_margins():
    assert chip_smoke.solver_gaps([2.0, 1.0], [2.0, 1.5]) == [0.0, 0.5 / 1.5]
    assert chip_smoke.solver_gaps([0.5], [0.25]) == [0.25]    # floor of 1
    assert chip_smoke.solver_gaps([1.0], [1.0, 2.0]) is None
    assert chip_smoke.armijo_margins([(0, 1.0, 2.0, 2.5),
                                      (0, 0.5, 3.0, 2.5)]) == [
        (0, 1.0, -0.5), (0, 0.5, 0.5)]


def test_transfer_readings_sit_under_the_solver_row():
    """The readings the row was set from: a one-ulp nudge of LeNet's start
    moves no score by a tenth of the row, and every line-search trial's
    Armijo margin is far outside it."""
    r = chip_smoke.transfer_readings()
    for algo in chip_smoke.TR_SOLVERS:
        assert len(r[algo]["scores"]) == chip_smoke.TR_SOLVER_ITERS
        assert r[algo]["scores"][-1] < r[algo]["scores"][0]
        assert r[algo]["worst"] <= chip_smoke.TOL_TRANSFER_SOLVER / 10
        assert min(abs(m) for _, _, m in r[algo]["margins"]) > \
            100 * chip_smoke.TOL_TRANSFER_SOLVER


@pytest.mark.parametrize("kernel", [0, 1, 9, 15, 18, 20])
def test_path_launch_checks_catch_a_transfer_launch(kernel):
    paths = _path_launches()
    chip_smoke.check_path_launches(*paths)
    bad = list(paths[13])
    bad[kernel] = 3
    paths[13] = tuple(bad)
    with pytest.raises(AssertionError):
        chip_smoke.check_path_launches(*paths)


@pytest.mark.parametrize("kernel", [0, 1, 9, 15, 18, 20])
def test_path_launch_checks_catch_a_scoring_launch(kernel):
    """A hand kernel, or the attention op's plain route, launched on the
    scoring path fails the whole check and the scoring phase's own
    (``--scoring`` alone)."""
    paths = _path_launches()
    chip_smoke.check_path_launches(*paths)
    chip_smoke.check_scoring_launches(paths[14])
    bad = list(paths[14])
    bad[kernel] = 3
    paths[14] = tuple(bad)
    with pytest.raises(AssertionError):
        chip_smoke.check_path_launches(*paths)
    with pytest.raises(AssertionError):
        chip_smoke.check_scoring_launches(paths[14])


def test_copy_overlap_counts_copies_under_other_streams_kernels(tmp_path):
    """``copy_overlap`` reads a Chrome trace: a copy's time under kernels
    of other streams counts (once where two overlap), its own stream's
    kernels do not."""
    def ev(cat, ts, dur, stream, name="k"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"stream": stream}}
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        ev("kernel", 0, 100, 7), ev("kernel", 150, 50, 7),
        ev("kernel", 60, 30, 9),
        ev("gpu_memcpy", 50, 120, 20, "Memcpy HtoD (Pinned -> Device)"),
        ev("gpu_memcpy", 120, 10, 7, "Memcpy DtoH (Device -> Pageable)"),
        {"ph": "i", "cat": "kernel", "ts": 0}]}))
    got = chip_smoke.copy_overlap(trace)
    assert got["copies"] == 2 and got["copy_us"] == 130.0
    assert got["under_kernels_us"] == 70.0
    assert got["copy_streams"] == [20, 7]
    assert got["kernel_streams"] == [7, 9]


def test_separation_is_the_nearest_other_image():
    """``separation``: the smallest ‖w_i − w_j‖ / ‖w_i‖ over the rows of
    every reference, a 3-image request's rows each counting."""
    wants = {(0, 0): np.array([[0.6, 0.4]]),
             (0, 1): np.array([[0.5, 0.5], [0.1, 0.9], [0.62, 0.38]])}
    rows = np.array([[0.6, 0.4], [0.5, 0.5], [0.1, 0.9], [0.62, 0.38]])
    want = min(np.linalg.norm(rows[i] - rows[j]) / np.linalg.norm(rows[i])
               for i in range(4) for j in range(4) if i != j)
    assert chip_smoke.separation(wants) == pytest.approx(want, rel=1e-9)
    assert want < 0.05
