"""Hooks through which the port reports the work that PyTorch's
dispatcher does not see, to whatever counts it (`launch.cost.Counter`).

Two kinds of work escape the dispatcher:

* a CUDA kernel, called through ``ctypes`` (`kernels.build`): its wrapper,
  and the model code that chooses between it and its plain version, run
  inside one `kernel_call` that the kernel's module builds from the
  call's tensors (``counted_flash``, ``counted_decode``,
  ``counted_scan``, the combines' ``_counted``). It hands the active
  counter the kernel's operations and bytes from one formula of its
  shapes (`kernels.work`) and suspends the counting of tensor operations
  until it ends. The plain version therefore counts as the kernel does
  (on ``meta`` it only shapes its result: `shapes_only`), and a step
  counts the same on the card, on the CPU and on ``meta`` tensors;
* a collective (`repro_torch.distributed`), which reports its kind and
  its output and operand bytes through `collective`.

`repeated` is a count's trip-count shortcut for a long time loop on
``meta`` tensors: two short runs of the loop, counted as the whole loop.

With no counter active (every run but a count) both cost one list test.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch

#: The active counters, innermost last (process-wide, like the ambient
#: mesh: autograd may run a backward pass on a thread of its own).
_ACTIVE: List["object"] = []
#: The name of the kernel whose region is open, or None.
_REGION: List[Optional[str]] = [None]
#: The factor by which work counted now is multiplied (`repeated`).
_SCALE: List[float] = [1.0]
#: A time loop of T steps (the sLSTM's), counted on ``meta`` tensors
#: where T is a multiple of this larger than it, runs its first
#: ``LOOP_STEPS`` and ``2 LOOP_STEPS`` steps only (`repeated`), as the
#: reference's cost model multiplies a while loop's body by its trip
#: count.
LOOP_STEPS = 16


def active():
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` the active one while the block runs."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.remove(counter)


def scale() -> float:
    """The factor of the work counted now (1 outside `repeated`)."""
    return _SCALE[0]


@contextlib.contextmanager
def _scaled(factor: int):
    old = _SCALE[0]
    _SCALE[0] = old * factor
    try:
        yield
    finally:
        _SCALE[0] = old


class _Repeated(torch.autograd.Function):
    """A time loop ``fn(x, *params)`` over ``x [B, T, ...]`` whose steps
    after the first all do the same work, counted from the loops over
    ``x``'s first ``2 n`` and first ``n`` steps, forward and backward,
    ``T / n - 1`` and ``2 - T / n`` times: a loop's count is affine in
    its steps, so this is the whole loop's exactly. The result, ``[B, T,
    ...]``, and the gradients are not computed. Only for a count on
    ``meta`` tensors."""

    @staticmethod
    def forward(ctx, fn, n, x, *params):
        T = x.shape[1]
        ctx.runs, ctx.like = [], [(t.shape, t.dtype) for t in (x,) + params]
        # The inner graphs keep what they save: an outer recomputation
        # (remat's saved-tensor hooks) must not replay them once more.
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            for steps, factor in ((2 * n, T // n - 1), (n, 2 - T // n)):
                if factor == 0:
                    continue
                leaves = [t.detach().requires_grad_(t.requires_grad)
                          for t in (x[:, :steps],) + params]
                with _scaled(factor):
                    out = fn(*leaves)
                ctx.runs.append((factor, out, leaves))
        return out.new_empty(x.shape[:2] + out.shape[2:])

    @staticmethod
    def backward(ctx, grad):
        for factor, out, leaves in ctx.runs:
            need = [t for t in leaves if t.requires_grad]
            with _scaled(factor):
                torch.autograd.grad(out, need, grad[:, :out.shape[1]],
                                    allow_unused=True)
        return (None, None) + tuple(grad.new_empty(s, dtype=d)
                                    for s, d in ctx.like)


def repeated(fn, n: int, x: torch.Tensor, *params) -> torch.Tensor:
    """`_Repeated`: the loop ``fn(x, *params)`` over ``x``'s T steps,
    counted from runs of ``2 n`` and ``n`` of them."""
    return _Repeated.apply(fn, n, x, *params)


def in_kernel_call() -> bool:
    """True inside a kernel's region (`kernel_call`)."""
    return _REGION[0] is not None


def shapes_only(x: torch.Tensor) -> bool:
    """True where a plain version need only return its result's shape:
    on ``meta`` tensors inside a kernel's region, which the kernel's
    formula counts."""
    return x.is_meta and _REGION[0] is not None


class kernel_call:
    """The region of one call of kernel ``name`` (a context manager):
    ``work()`` gives its ``(operations, bytes)``, handed to the active
    counter (computed only when one is active). Tensor operations inside
    are not counted; a region opened inside another counts nothing (the
    outer one declared the call)."""

    __slots__ = ("name", "work", "outer")

    def __init__(self, name: str,
                 work: Callable[[], Tuple[float, float]]):
        self.name, self.work = name, work

    def __enter__(self) -> None:
        self.outer = _REGION[0]
        if _ACTIVE and self.outer is None:
            flops, nbytes = self.work()
            _ACTIVE[-1].kernel(self.name, flops, nbytes)
        _REGION[0] = self.outer or self.name

    def __exit__(self, *exc) -> None:
        _REGION[0] = self.outer


def _bytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def collective(kind: str, outputs: Sequence[torch.Tensor],
               operands: Sequence[torch.Tensor]) -> None:
    """Report one collective of ``kind`` (the reference's HLO names:
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute") with its per-rank outputs and operands."""
    counter = active()
    if counter is not None and _REGION[0] is None:
        counter.collective(kind, _bytes(outputs), _bytes(operands))
