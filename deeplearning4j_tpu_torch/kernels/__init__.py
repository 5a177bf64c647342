"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Each wrapper adds one to a module-level counter where it launches its
kernel, and nowhere else (a CPU tensor takes the plain version and counts
nothing). One count is no kernel's: ``attention_plain``, the calls of
``ops.standard.dot_product_attention`` on the card that took the op's
plain version by its stated rule. :func:`launch_counts` reads every
counter of this process by name; :func:`reset_launch_counts` zeroes
them.
"""
import importlib

#: each kernel's launch counter as (module, attribute), by kernel name
COUNTERS = {
    "wgmma": ("flash_attention", "launches_wgmma"),
    "simple": ("flash_attention", "launches_simple"),
    "bwd_wgmma": ("flash_attention", "launches_bwd_wgmma"),
    "bwd": ("flash_attention", "launches_bwd"),
    "ce_fwd": ("chunked_ce", "launches_fwd"),
    "ce_dlogits": ("chunked_ce", "launches_dlogits"),
    "moe_dispatch": ("moe_route", "launches_dispatch"),
    "moe_combine": ("moe_route", "launches_combine"),
    "ce_fwd_wgmma": ("chunked_ce", "launches_fwd_wgmma"),
    "ce_dlogits_wgmma": ("chunked_ce", "launches_dlogits_wgmma"),
    "paged_attention": ("paged_attention", "launches_attend"),
    "kv_quant_write": ("paged_attention", "launches_quant_write"),
    "ce_fwd_tf32": ("chunked_ce", "launches_fwd_tf32"),
    "ce_dlogits_tf32": ("chunked_ce", "launches_dlogits_tf32"),
    "ce_split_tf32": ("chunked_ce", "launches_split_tf32"),
    "paged_attention_write": ("paged_attention", "launches_attend_write"),
    "rnn_cell_fwd": ("rnn_cell", "launches_cell_fwd"),
    "rnn_cell_bwd": ("rnn_cell", "launches_cell_bwd"),
    "rnn_layer_fwd": ("rnn_cell", "launches_layer_fwd"),
    "rnn_layer_bwd": ("rnn_cell", "launches_layer_bwd"),
    "attention_plain": ("flash_attention", "plain_route_calls"),
}


def _module(name):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """Every kernel's launches in this process so far, by kernel name, in
    the order of :data:`COUNTERS`."""
    return {k: getattr(_module(m), a) for k, (m, a) in COUNTERS.items()}


def reset_launch_counts() -> None:
    """Zero every kernel's launch counter in this process."""
    for m, a in COUNTERS.values():
        setattr(_module(m), a, 0)
