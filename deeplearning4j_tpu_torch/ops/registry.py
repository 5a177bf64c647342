"""Op registry: named ops over torch tensors, with shape inference.

Counterpart of ``deeplearning4j_tpu/ops/registry.py`` (libnd4j's
declarable-op registry). An op is a named callable over tensors (its
attributes are Python values); the graph engine (``autodiff/``) and the
TF importer emit and run ops by name. Shape inference runs the op on
``device="meta"`` tensors, which carry shapes and dtypes and no data: the
counterpart of ``jax.eval_shape`` over the op's body.

The JAX package runs with 64-bit types off, so its ops never give int64:
where torch does (indices, ``arange``, ``argmax``), :class:`OpDef` casts
the result to int32, so an op's dtypes match the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch


class UnknownOpError(KeyError):
    """The registry holds no op by this name."""

    def __init__(self, name: str):
        super().__init__(name)
        self.name = name

    def __str__(self):
        return f"Unknown op: {self.name!r}. {len(names())} ops registered."


def _int32(out):
    if isinstance(out, torch.Tensor):
        return out.to(torch.int32) if out.dtype == torch.int64 else out
    if isinstance(out, (tuple, list)):
        return type(out)(_int32(o) for o in out)
    return out


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable                     # (*tensors, **attrs) -> tensor(s)
    num_outputs: int = 1
    aliases: tuple = ()
    # platform override (a hand kernel). When set and enabled, used
    # instead of ``fn``, the PlatformHelper analog.
    platform_fn: Optional[Callable] = None

    def __call__(self, *args, **attrs):
        fn = (self.platform_fn if (self.platform_fn is not None
                                   and _platform_overrides_enabled)
              else self.fn)
        return _int32(fn(*args, **attrs))


_REGISTRY: Dict[str, OpDef] = {}
_platform_overrides_enabled = True


def register(name: str, fn: Callable = None, *, num_outputs: int = 1,
             aliases: Sequence[str] = ()):
    """Register an op. Usable as decorator or direct call."""
    def do_register(f):
        op = OpDef(name=name, fn=f, num_outputs=num_outputs,
                   aliases=tuple(aliases))
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return f
    if fn is not None:
        return do_register(fn)
    return do_register


def alias(existing: str, *spellings: str):
    """Bind alternate spellings to an existing OpDef. Raises on collision
    with a DIFFERENT op."""
    op = get(existing)
    for s in spellings:
        bound = _REGISTRY.get(s)
        if bound is not None and bound is not op:
            raise ValueError(
                f"alias {s!r} already bound to op {bound.name!r}; "
                f"refusing to rebind to {op.name!r}")
        _REGISTRY[s] = op


def register_platform(name: str, fn: Callable):
    """Attach an accelerated override to an existing op."""
    _REGISTRY[name].platform_fn = fn


def set_platform_overrides(enabled: bool):
    """Global toggle, used by cross-check tests (kernel vs plain)."""
    global _platform_overrides_enabled
    _platform_overrides_enabled = enabled


def get(name: str) -> OpDef:
    op = _REGISTRY.get(name)
    if op is None:
        raise UnknownOpError(name)
    return op


def has(name: str) -> bool:
    return name in _REGISTRY


def names() -> list:
    return sorted({op.name for op in _REGISTRY.values()})


def exec_op(name: str, *args, **attrs):
    return get(name)(*args, **attrs)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def infer_shape(name: str, *args, **attrs):
    """Shape inference without execution: the op run on meta tensors
    (ref: ``DeclarableOp#calculateOutputShape``, ``jax.eval_shape``).
    Returns meta tensors (``.shape``, ``.dtype``)."""
    return get(name)(*[_meta(a) for a in args], **attrs)
