"""Compressed gradient exchange: error-feedback threshold collectives.

Counterpart of ``deeplearning4j_tpu/parallel/compression.py`` (the
reference's ``EncodedGradientsAccumulator`` + ``ThresholdAlgorithm``, Strom
2015): each replica ships only the sign of the gradient entries whose
accumulated magnitude clears a threshold, and keeps the rest as a local
residual that re-enters the next step.

- The threshold algorithms, the spec grammar and the
  ``DL4J_TPU_GRAD_COMPRESS`` knob (``0`` is the kill switch) are the
  reference's. The adaptive update runs on the device on the replicas'
  mean encoded fraction, so every rank computes the same threshold.
- Buckets: the gradient leaves flatten into dtype-homogeneous 1-D f32
  buckets, one exchange per bucket.
- :func:`exchange_bucket` is the one spelling of the exchange over a
  process group, on the K6 kernels (``kernels/threshold.py``): K6e encodes
  and reduces the bucket's scalars, one all-reduce carries every scalar,
  one all-reduce sums the int8 signs (``ReduceOp.SUM``, never AVG), K6d
  decodes ``wire·scale/n``, the residual ``acc − signs·scale`` and its
  squared norm. On the CPU the kernels' plain versions run.
- The state is the reference's: per-replica residual buckets (global form
  ``(n_replicas, size)``) and per-bucket threshold scalars; it rides the
  checkpoint as ``gradCompression.npz``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import threshold as _k6

#: env knob: ``0`` = kill switch (dense path), ``1`` /
#: ``adaptive[:init[:min:max]]`` / ``fixed[:threshold]`` = enable
ENV_KNOB = "DL4J_TPU_GRAD_COMPRESS"

#: process-group all-reduces the exchange issued in this process (plain
#: integer; set it to 0 to count one run's)
allreduce_calls = 0


# ---------------------------------------------------------------- algorithms
class ThresholdAlgorithm:
    """Base threshold policy (ref: ``encoding.ThresholdAlgorithm``):
    :meth:`update` runs on the device on the replicas' mean encoded
    fraction, so every replica computes the same next threshold."""

    initial_threshold: float = 1e-3

    def update(self, threshold: torch.Tensor,
               encoded_fraction: torch.Tensor) -> torch.Tensor:
        return threshold

    def describe(self) -> dict:
        return {"algorithm": type(self).__name__,
                "initial_threshold": float(self.initial_threshold)}


@dataclasses.dataclass(frozen=True)
class FixedThresholdAlgorithm(ThresholdAlgorithm):
    """ref: ``FixedThresholdAlgorithm`` — constant threshold."""
    initial_threshold: float = 1e-3


@dataclasses.dataclass(frozen=True)
class AdaptiveThresholdAlgorithm(ThresholdAlgorithm):
    """ref: ``AdaptiveThresholdAlgorithm``: decay the threshold by
    ``decay_rate`` while the encoded fraction is under
    ``min_target_fraction``, grow it while it is over
    ``max_target_fraction``; clipped to [1e-10, 1e6]."""
    initial_threshold: float = 1e-3
    min_target_fraction: float = 1e-4
    max_target_fraction: float = 1e-2
    decay_rate: float = 0.95

    def update(self, threshold, encoded_fraction):
        t = torch.where(encoded_fraction < self.min_target_fraction,
                        threshold * self.decay_rate, threshold)
        t = torch.where(encoded_fraction > self.max_target_fraction,
                        t / self.decay_rate, t)
        return torch.clamp(t, 1e-10, 1e6)

    def describe(self) -> dict:
        d = ThresholdAlgorithm.describe(self)
        d.update(min_target_fraction=self.min_target_fraction,
                 max_target_fraction=self.max_target_fraction,
                 decay_rate=self.decay_rate)
        return d


def algorithm_from_spec(spec) -> Optional[ThresholdAlgorithm]:
    """A builder arg or env value → a ThresholdAlgorithm, as the
    reference: an instance passes through, ``True`` / ``"1"`` is adaptive
    with defaults, ``"adaptive[:init[:min:max]]"``,
    ``"fixed[:threshold]"``; ``None`` / ``False`` / ``"0"`` / ``""`` →
    None (compression off). Anything else raises ValueError."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, ThresholdAlgorithm):
        return spec
    if spec is True:
        return AdaptiveThresholdAlgorithm()
    s = str(spec).strip()
    if s in ("", "0"):
        return None
    if s == "1":
        return AdaptiveThresholdAlgorithm()
    parts = s.split(":")
    kind, args = parts[0].lower(), parts[1:]
    try:
        if kind == "fixed":
            if len(args) > 1:
                raise ValueError(
                    f"bad {ENV_KNOB} spec {s!r}: fixed takes at most one "
                    "argument (the threshold)")
            return FixedThresholdAlgorithm(
                initial_threshold=float(args[0]) if args else 1e-3)
        if kind == "adaptive":
            if len(args) not in (0, 1, 3):
                raise ValueError(
                    f"bad {ENV_KNOB} spec {s!r}: adaptive takes 0, 1 "
                    "(init) or 3 (init:min:max) arguments, got "
                    f"{len(args)}")
            kw = {}
            if args:
                kw["initial_threshold"] = float(args[0])
            if len(args) == 3:
                kw["min_target_fraction"] = float(args[1])
                kw["max_target_fraction"] = float(args[2])
            return AdaptiveThresholdAlgorithm(**kw)
    except ValueError as e:
        raise ValueError(f"bad {ENV_KNOB} spec {s!r}: {e}") from None
    raise ValueError(
        f"bad {ENV_KNOB} spec {s!r} (want 0 | 1 | fixed[:thr] | "
        f"adaptive[:init[:min:max]])")


def resolve_compression(arg=None) -> Optional[ThresholdAlgorithm]:
    """Builder arg + env knob → the active algorithm (None = dense). The
    knob ``0`` forces the dense path even when an arg asked for
    compression; otherwise an explicit arg wins; with none the knob's spec
    decides. Read live, at placement."""
    env = os.environ.get(ENV_KNOB, "").strip()
    if env == "0":
        return None
    if arg is not None:
        return algorithm_from_spec(arg)
    return algorithm_from_spec(env) if env else None


# ------------------------------------------------------------------- buckets
@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    bucket: int          # bucket index
    offset: int          # start offset in the bucket's 1-D buffer
    size: int
    shape: Tuple[int, ...]
    dtype: str


_FLOAT = {torch.float32: "float32", torch.float64: "float64",
          torch.bfloat16: "bfloat16", torch.float16: "float16"}
_DTYPE = {v: k for k, v in _FLOAT.items()}


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Gradient leaves (a list, in the net's flat order) ↔ dtype-homogeneous
    1-D buckets: leaves grouped by dtype in order, one exchange per
    bucket, the threshold over the whole bucket's mass."""
    slots: Tuple[_LeafSlot, ...]
    bucket_dtypes: Tuple[str, ...]
    bucket_sizes: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    def total_elements(self) -> int:
        return sum(self.bucket_sizes)


def build_layout(leaves: Sequence[torch.Tensor]) -> BucketLayout:
    """The layout of a list of float leaves (non-float raises, as the
    reference)."""
    by_dtype: Dict[str, int] = {}
    offsets: List[int] = []
    slots = []
    sizes: List[int] = []
    dtypes: List[str] = []
    for leaf in leaves:
        if leaf.dtype not in _FLOAT:
            raise ValueError(
                f"gradient leaf with non-float dtype {leaf.dtype} cannot "
                "join a compressed bucket")
        dt = _FLOAT[leaf.dtype]
        if dt not in by_dtype:
            by_dtype[dt] = len(sizes)
            sizes.append(0)
            dtypes.append(dt)
            offsets.append(0)
        b = by_dtype[dt]
        size = int(leaf.numel())
        slots.append(_LeafSlot(b, offsets[b], size, tuple(leaf.shape), dt))
        offsets[b] += size
        sizes[b] += size
    return BucketLayout(tuple(slots), tuple(dtypes), tuple(sizes))


def flatten_buckets(leaves: Sequence[torch.Tensor],
                    layout: BucketLayout) -> List[torch.Tensor]:
    """Leaves → per-dtype 1-D f32 buckets (new buffers)."""
    parts: List[List[torch.Tensor]] = [[] for _ in layout.bucket_sizes]
    for leaf, slot in zip(leaves, layout.slots):
        parts[slot.bucket].append(leaf.reshape(-1).float())
    return [torch.cat(p) if len(p) > 1 else p[0].clone() for p in parts]


def unflatten_buckets(buckets: Sequence[torch.Tensor],
                      layout: BucketLayout) -> List[torch.Tensor]:
    """Per-dtype 1-D buckets → leaves of their shapes and dtypes: views
    of the buckets where the dtype is f32."""
    out = []
    for slot in layout.slots:
        seg = buckets[slot.bucket][slot.offset:slot.offset + slot.size]
        seg = seg.view(slot.shape)
        dt = _DTYPE[slot.dtype]
        out.append(seg if seg.dtype == dt else seg.to(dt))
    return out


# --------------------------------------------------------------------- codec
def wire_dtype(n_replicas: int) -> torch.dtype:
    """The sign-sum wire's type: the sum of ±1 over the replicas fits int8
    up to 127 of them, else int16."""
    return torch.int8 if n_replicas <= 127 else torch.int16


def encode_dense(acc: torch.Tensor, threshold) -> torch.Tensor:
    """The reference's dense sign-mask encode: int8 in {-1, 0, +1}."""
    return torch.where(acc.abs() >= threshold, torch.sign(acc),
                       torch.zeros((), dtype=acc.dtype, device=acc.device)
                       ).to(torch.int8)


@dataclasses.dataclass
class Exchanged:
    """One bucket's exchange: ``decoded`` (the replica-mean decoded
    gradient), ``residual`` (this replica's ``acc − sent``), ``signs``
    (this replica's int8 mask), ``wire`` (the summed signs), ``scale``
    and ``frac`` (0-d, the same on every replica), ``res_sq`` (this
    replica's Σ residual'²) and ``packed`` (the summed scalars K6d read).
    ``sent`` is ``signs · scale``."""
    decoded: torch.Tensor
    residual: torch.Tensor
    signs: torch.Tensor
    wire: torch.Tensor
    scale: torch.Tensor
    frac: torch.Tensor
    res_sq: torch.Tensor
    packed: torch.Tensor

    @property
    def sent(self) -> torch.Tensor:
        return self.signs.float() * self.scale


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (counted in
    :data:`allreduce_calls`)."""
    global allreduce_calls
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    allreduce_calls += 1
    return t


def mean_over(tensors: List[torch.Tensor], group, n: int
              ) -> List[torch.Tensor]:
    """The mean of each tensor over the ``n`` ranks of ``group``: one
    all-reduce of a flat buffer for each dtype among them, scaled in
    place. The results are views of those buffers, in the input's order
    and shapes (the dense exchange's gradients and loss)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]),
                          group).div_(n)
        off = 0
        for i in idx:
            size = tensors[i].numel()
            out[i] = flat[off:off + size].view(tensors[i].shape)
            off += size
    return out


def exchange_bucket(g: torch.Tensor, residual: torch.Tensor,
                    threshold: torch.Tensor, group, n_replicas: int,
                    decoded: Optional[torch.Tensor] = None,
                    new_residual: Optional[torch.Tensor] = None
                    ) -> Exchanged:
    """One bucket's threshold exchange over ``group`` (every rank calls
    it): K6e on ``acc = g + residual``, one all-reduce of the three
    scalars, one of the int8 signs, K6d. ``decoded`` may be ``g`` (the
    bucket the leaves view) and ``new_residual`` a second residual
    buffer. The decode scale is the mean |acc| of the fired entries,
    averaged over the replicas that fired anything (the reference's
    scaled-sign decode)."""
    return exchange_buckets([g], [residual], [threshold], group, n_replicas,
                            [decoded], [new_residual])[0]


def exchange_buckets(gs, residuals, thresholds, group, n_replicas: int,
                     decoded=None, new_residuals=None) -> List[Exchanged]:
    """:func:`exchange_bucket` over several buckets with one all-reduce of
    every bucket's scalars (packed) and one of each bucket's signs."""
    nb = len(gs)
    dev = gs[0].device
    packed = torch.empty(3 * nb, dtype=torch.float32, device=dev)
    signs = []
    for i, (g, r, t) in enumerate(zip(gs, residuals, thresholds)):
        s, _ = _k6.encode_dense(g, r, t, packed=packed[3 * i:3 * i + 3])
        signs.append(s)
    all_reduce(packed, group)
    out = []
    wdt = wire_dtype(n_replicas)
    for i, (g, r, s) in enumerate(zip(gs, residuals, signs)):
        wire = s if wdt == torch.int8 else s.to(wdt)
        wire = all_reduce(wire.clone(), group)
        p = packed[3 * i:3 * i + 3]
        dec, nres, q = _k6.decode_dense(
            g, r, s, wire, p, n_replicas,
            decoded=None if decoded is None else decoded[i],
            new_residual=None if new_residuals is None else new_residuals[i])
        scale = p[0] / torch.clamp_min(p[1], 1.0)
        out.append(Exchanged(dec, nres, s, wire, scale, p[2] / n_replicas,
                             q, p))
    return out


def payload_bytes(layout: BucketLayout, n_replicas: int) -> int:
    """The compressed exchange's wire payload a step: one sign entry per
    element plus one f32 scale and one f32 encoded fraction a bucket."""
    itemsize = torch.empty((), dtype=wire_dtype(n_replicas)).element_size()
    return layout.total_elements() * itemsize + 8 * layout.n_buckets


def dense_bytes(layout: BucketLayout) -> int:
    """What the dense all-reduce moves: the leaves' own bytes."""
    return sum(size * torch.empty((), dtype=_DTYPE[dt]).element_size()
               for size, dt in zip(layout.bucket_sizes, layout.bucket_dtypes))


# --------------------------------------------------------- state + checkpoint
def init_state(layout: BucketLayout, algorithm: ThresholdAlgorithm,
               n_replicas: int, device=None) -> dict:
    """A fresh state in the global form: residual buckets
    ``(n_replicas, size)`` of zeros and each bucket's threshold."""
    return {
        "residual": [torch.zeros((n_replicas, size), dtype=torch.float32,
                                 device=device)
                     for size in layout.bucket_sizes],
        "threshold": [torch.tensor(algorithm.initial_threshold,
                                   dtype=torch.float32, device=device)
                      for _ in layout.bucket_sizes],
    }


def state_matches(state: Optional[dict], layout: BucketLayout,
                  n_replicas: int) -> bool:
    """Does a (restored) global-form state fit this layout and replica
    count?"""
    if not isinstance(state, dict):
        return False
    res = state.get("residual")
    thr = state.get("threshold")
    if res is None or thr is None or len(res) != layout.n_buckets \
            or len(thr) != layout.n_buckets:
        return False
    return all(tuple(np.shape(r)) == (n_replicas, size)
               for r, size in zip(res, layout.bucket_sizes))


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a).to(torch.float32)


def reshape_state(state: Optional[dict], layout: BucketLayout,
                  n_replicas: int):
    """Carry a global-form state across a replica-count change, as the
    reference: ``(state, "match")``; ``(state, "rebucketed")`` (shrink by
    group means, expand by tiling); ``(state, "reseeded")`` (residuals at
    zero when the counts do not divide); ``(None, "layout_mismatch")``.
    Thresholds are kept in every non-None case."""
    if not isinstance(state, dict):
        return None, "layout_mismatch"
    res = state.get("residual")
    thr = state.get("threshold")
    if res is None or thr is None or len(res) != layout.n_buckets \
            or len(thr) != layout.n_buckets \
            or any(np.ndim(r) != 2 or np.shape(r)[1] != size
                   for r, size in zip(res, layout.bucket_sizes)):
        return None, "layout_mismatch"
    old_n = int(np.shape(res[0])[0])
    if any(int(np.shape(r)[0]) != old_n for r in res):
        return None, "layout_mismatch"
    thresholds = [_f32(t) for t in thr]
    res = [_f32(r) for r in res]
    if old_n == n_replicas:
        return {"residual": res, "threshold": thresholds}, "match"
    if old_n % n_replicas == 0:
        g = old_n // n_replicas
        new_res = [torch.mean(r.reshape(n_replicas, g, -1), dim=1)
                   for r in res]
        return {"residual": new_res, "threshold": thresholds}, "rebucketed"
    if n_replicas % old_n == 0:
        g = n_replicas // old_n
        new_res = [torch.repeat_interleave(r, g, dim=0) for r in res]
        return {"residual": new_res, "threshold": thresholds}, "rebucketed"
    new_res = [torch.zeros((n_replicas, size), dtype=torch.float32)
               for size in layout.bucket_sizes]
    return {"residual": new_res, "threshold": thresholds}, "reseeded"


def state_to_arrays(state: dict) -> Dict[str, np.ndarray]:
    """The checkpoint form (``gradCompression.npz``): each residual as the
    global ``(n_replicas, size)`` array and each threshold. A state placed
    by a trainer over several ranks holds this rank's row only; its rows
    are gathered from every rank (a collective: every rank calls it)."""
    group = state.get("group")
    world = int(state.get("world", 1))
    out = {}
    for i, r in enumerate(state["residual"]):
        if world > 1:
            import torch.distributed as dist
            rows = [torch.empty_like(r) for _ in range(world)]
            dist.all_gather(rows, r.contiguous(), group=group)
            r = torch.cat(rows, dim=0)
        out[f"residual_{i}"] = r.detach().to("cpu", torch.float32).numpy()
    for i, t in enumerate(state["threshold"]):
        out[f"threshold_{i}"] = np.asarray(
            t.detach().to("cpu", torch.float32).numpy()
            if isinstance(t, torch.Tensor) else t, np.float32)
    return out


def state_from_arrays(arrays: Dict[str, np.ndarray]) -> Optional[dict]:
    """A global-form state from checkpoint arrays (None when there is
    none, or an entry is missing)."""
    n = sum(1 for k in arrays if k.startswith("residual_"))
    if n == 0:
        return None
    try:
        return {
            "residual": [torch.as_tensor(np.asarray(arrays[f"residual_{i}"]))
                         for i in range(n)],
            "threshold": [torch.as_tensor(
                np.asarray(arrays[f"threshold_{i}"]))
                for i in range(n)],
        }
    except KeyError:
        return None
