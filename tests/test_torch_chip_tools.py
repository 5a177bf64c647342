"""The CPU-side arithmetic of ``chip_smoke.py``.

It runs on the card; what it computes from shapes and text (the bound it
holds each kernel to, the profiler's busy share, the ptxas report it
checks the wgmma kernel's build against) is checked here.
"""
import pytest

import chip_smoke


def test_bound_at_the_main_shape_is_pr1s():
    ms, by = chip_smoke.attention_bound_ms(16, 1024, 1024, 64, "bfloat16",
                                           True)
    assert by == "bytes" and ms == pytest.approx(0.0025236250746268657)


def test_bound_counts_only_kept_causal_pairs():
    # Tq 3, Tk 2: rows keep 1, 2, 2 keys
    flops_ms, _ = chip_smoke.attention_bound_ms(1, 3, 2, 64, "float32", True)
    ops = 4.0 * 64 * (1 + 2 + 2) / chip_smoke.PEAK_FLOPS["float32"]
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
    assert old["max_abs_err"] == pytest.approx(10e-3)


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
    (the wgmma and mma.sync ones, and the small D pass), each with its
    device time and count."""
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
        kernel("void dkdv_kernel_bf16<64>(Args)", 84, 6)]

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
    assert row["busy_share"] == pytest.approx(0.9)    # 90 of 100 us
