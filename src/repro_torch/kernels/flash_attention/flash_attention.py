"""Blocked causal GQA attention with an online softmax: three hand-written
CUDA kernels for Hopper and their plain PyTorch version.

The kernels (``src/repro_torch/csrc/flash_attention.cu``, whose source note
gives their designs) replace the Pallas TPU kernel
``flash_attention_batched`` of
``repro/kernels/flash_attention/flash_attention.py``. `select_kernel`
picks one from the shapes and the type alone:

=========================================  ==========================
CUDA input (rows = ``group * Tq``)         kernel (``LAUNCHES`` key)
=========================================  ==========================
bfloat16, ``Dh`` in `WGMMA_HEAD_DIMS`:     split-K decode + its merge
rows <= `WGMMA_DECODE_MAX_ROWS`;           (``flash_attention_decode``)
otherwise rows <= `DECODE_MAX_ROWS`
bfloat16, ``Dh`` in `WGMMA_HEAD_DIMS`,     ``wgmma`` + TMA prefill
more rows                                  (``flash_attention_wgmma``)
everything else (float32, other ``Dh``)    the FMA kernel
                                           (``flash_attention``)
=========================================  ==========================

``flash_attention_plain`` computes the same function with tensor ops, one
query block at a time with an online softmax over key blocks, in float32,
so its memory stays O(block_q · block_k) per head. It serves CPU tensors
and is the on-card reference.

Conventions of all (and of the oracle ``ref.attention_ref``): queries are
right-aligned to the keys (query ``i`` at position ``Tk - Tq + i``);
causal masking uses -1e30; a row that sees no key (causal, ``Tq > Tk``)
averages ``v`` over the ``Tk`` real keys. A sliding ``window > 0``
(causal only) also masks the keys that lie ``window`` or more positions
before the query (a query at p sees the keys ``p - window < k <= p``: the
mask of the reference model's ``blockwise_causal_attention``); key blocks
wholly below the window are skipped. The JAX kernel averages its
block padding there too, so for those rows it differs from its own oracle.
A logit ``softcap > 0`` (grok's attention) maps each scaled score ``s``
to ``softcap * tanh(s / softcap)`` before the masks, as the reference
model's attention does (``repro/models/attention.py``); masked scores
stay at -1e30. All three kernels and both plain versions take it.
The ``wgmma`` kernel rounds the softmax weights to bfloat16 before the
second product (the TPU kernel keeps them in float32).

``flash_attention_cuda`` is the kernels' wrapper. A CPU tensor takes the
plain version; a CUDA tensor launches the selected kernel or raises —
never a fallback to another kernel or to the plain version. Each launch
adds one to its kernel's ``LAUNCHES`` entry (the decode's merge pass is
part of its launch).

``decode_attention_cuda`` runs the split-K decode kernel against a KV
cache read in place: ``[B, Hkv, S, Dh]`` buffers whose first
``min(length, S)`` rows are keys, ``length`` an int32 tensor on the card
that the kernel reads itself (no host sync per step). Its plain version,
``decode_attention_plain``, is the reference's masked decode softmax
(``repro/models/attention.py`` ``decode_attention``) on this layout.
Both take a ``head_map`` (q head ``i`` reads kv head ``head_map[i]``, any
map: a tensor-parallel rank's q heads against its own cache block, where
the reference's padded heads make the groups uneven) and can return each
row's log-sum-exp (``return_lse``), with which a cache split along its
sequence over several ranks is merged across them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch import counting
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.work import decode_work, flash_work

#: Kernel launches since the last `reset_launch_counts`, per kernel.
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_wgmma": 0,
                            "flash_attention_decode": 0}
#: The kernel names `select_kernel` returns, and their `LAUNCHES` keys.
KERNEL_COUNTERS = {"fma": "flash_attention", "wgmma": "flash_attention_wgmma",
                   "decode": "flash_attention_decode"}

#: Head dims with compiled FMA and decode instances (the repo's configs
#: and the JAX suite use 16, 32, 64 and 128).
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Head dims of the bfloat16 ``wgmma`` prefill kernel.
WGMMA_HEAD_DIMS = (64, 128)
#: Query rows per kv head (``group * Tq``) the decode kernel takes at most.
DECODE_MAX_ROWS = 16
#: ... and at most this many where the ``wgmma`` kernel takes the input:
#: past 8 rows the decode kernel runs its 16-row instance and loses to
#: ``wgmma`` (``chip_smoke.py``'s crossover lines, bf16 at Llama-3.2-3B
#: width: decode 0.10-0.14 ms at 3-6 rows, 0.27-0.28 ms at 9-15, ``wgmma``
#: 0.23 ms throughout; NVIDIA H100 80GB HBM3, 700 W).
WGMMA_DECODE_MAX_ROWS = 8
#: Keys per split of the decode kernel: at most this many ...
DECODE_MAX_SPLIT = 512
#: ... and at least this many, halving from the most while the grid has
#: fewer than ``DECODE_CTAS_PER_SM`` CTAs per SM.
DECODE_MIN_SPLIT = 64
DECODE_CTAS_PER_SM = 4

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}

#: ``nvcc`` parts of ``csrc/flash_attention.cu``, compiled at the same
#: time: one per head_dim (its FMA and decode instances in both dtypes,
#: and at 64 and 128 its ``wgmma`` instance), and the C entry points.
BUILD_PARTS = tuple((f"-DFA_HEAD_DIM={d}",) for d in HEAD_DIMS) + (
    ("-DFA_ENTRY_POINTS",),)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless ``q [B, Hq, Tq, Dh]`` and ``k, v [B, Hkv, Tk, Dh]``
    fit together (``Hkv`` divides ``Hq``; ``Tk >= 1`` unless the output is
    empty)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "[B, Hq, Tq, Dh] and two equal [B, Hkv, Tk, Dh]")
    B, Hq, Tq, Dh = q.shape
    Bk, Hkv, Tk, Dk = k.shape
    if Bk != B or Dk != Dh:
        raise ValueError(f"flash_attention: batch/head_dim of q "
                         f"{(B, Dh)} and k {(Bk, Dk)} differ")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hkv={Hkv} does not divide "
                         f"Hq={Hq}")
    if Tk < 1 and q.numel():
        raise ValueError("flash_attention: no keys (Tk = 0)")


def select_kernel(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel a CUDA input of these shapes and type takes: "decode",
    "wgmma" or "fma" (see the module's table)."""
    Hq, Tq, Dh = q.shape[1:]
    rows = (Hq // k.shape[1]) * Tq
    if q.dtype == torch.bfloat16 and Dh in WGMMA_HEAD_DIMS:
        return "decode" if rows <= WGMMA_DECODE_MAX_ROWS else "wgmma"
    return "decode" if rows <= DECODE_MAX_ROWS else "fma"


def decode_split_keys(B: int, Hkv: int, Tk: int, n_sm: int) -> int:
    """Keys per split of the decode kernel: `DECODE_MAX_SPLIT`, halved
    (not below `DECODE_MIN_SPLIT`) while ``B * Hkv * splits`` CTAs give
    fewer than `DECODE_CTAS_PER_SM` per SM."""
    split = DECODE_MAX_SPLIT
    while (split > DECODE_MIN_SPLIT and
           B * Hkv * -(-Tk // split) < DECODE_CTAS_PER_SM * n_sm):
        split //= 2
    return split


def check_window(window: int, causal: bool) -> None:
    """Raise unless ``window`` is 0 (none) or positive with ``causal``."""
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention: window={window} with causal="
                         f"{causal}; a window is positive and causal")


def _key_range(first_qpos: int, end_qpos: int, Tk: int, causal: bool,
               window: int):
    """Keys ``[lo, hi)`` a query block must visit: from the first key in
    its first row's window up to its last position when causal, all of
    them when its first row sees no key (it averages them all)."""
    if not causal or first_qpos < 0:
        return 0, Tk
    lo = max(0, first_qpos - window + 1) if window > 0 else 0
    return lo, min(Tk, end_qpos)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_k: int = 128, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """``q [B, Hq, Tq, Dh]``, ``k/v [B, Hkv, Tk, Dh]`` -> ``[B, Hq, Tq, Dh]``
    in q's dtype: per block of ``block_q`` queries, an online softmax over
    blocks of ``block_k`` keys in float32. The query heads of one GQA group
    share their key/value head by broadcasting (no copy). ``window > 0``:
    a sliding window; ``softcap > 0``: the logit softcap (see the module
    docstring)."""
    check_shapes(q, k, v)
    check_window(window, causal)
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1:3]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0 or counting.shapes_only(q):
        return out   # meta: shapes only, counted by the kernel's formula
    qf = q.float().reshape(B, Hkv, group, Tq, Dh)
    kf = k.float()[:, :, None]    # [B, Hkv, 1, Tk, Dh]
    vf = v.float()[:, :, None]
    q_offset = Tk - Tq
    for q0 in range(0, Tq, block_q):
        q1 = min(q0 + block_q, Tq)
        qb = qf[:, :, :, q0:q1]
        m = qb.new_full(qb.shape[:-1] + (1,), _NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        qpos = torch.arange(q_offset + q0, q_offset + q1,
                            device=q.device)[:, None]
        lo, hi = _key_range(q_offset + q0, q_offset + q1, Tk, causal, window)
        for k0 in range(lo, hi, block_k):
            k1 = min(k0 + block_k, Tk)
            s = (qb @ kf[:, :, :, k0:k1].mT) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                seen = qpos >= kpos
                if window > 0:
                    seen = seen & (qpos - kpos < window)
                s = torch.where(seen, s, s.new_tensor(_NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, :, k0:k1]
            m = m_new
        acc = acc / torch.where(l > 0, l, torch.ones_like(l))
        out[:, :, q0:q1] = acc.reshape(B, Hq, q1 - q0, Dh).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _library():
    """Build (first call) and bind the kernels' C interface."""
    from repro_torch.kernels.build import build

    lib = build("flash_attention", BUILD_PARTS).lib
    if not getattr(lib, "_fa_bound", False):
        i, ll, f, ptr = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_void_p)
        lib.fa_attention.argtypes = [i, i, ll, i, i, ll, ll, i, i, f, f,
                                     ptr, ptr, ptr, ptr, ptr]
        lib.fa_decode.argtypes = [i, i, ll, i, i, ll, ll, i, i, f, f, i,
                                  ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.fa_wgmma.argtypes = [i, ll, i, i, ll, ll, i, i, f, f,
                                 ptr, ptr, ptr, ptr, ptr]
        lib.fa_decode_cache.argtypes = [i, i, ll, i, i, ll, ll, f, f, i,
                                        i, ptr, ptr, ptr, ptr, ptr, ptr,
                                        ptr, ptr, ptr, ptr]
        for fn in (lib.fa_attention, lib.fa_decode, lib.fa_wgmma,
                   lib.fa_decode_cache):
            fn.restype = ctypes.c_int
        lib.fa_smem_bytes.argtypes = [i, i, i, i, i]
        lib.fa_smem_bytes.restype = ll
        lib._fa_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_bytes(kernel: str, dtype: torch.dtype, head_dim: int, rows: int = 1,
               split_keys: int = DECODE_MAX_SPLIT) -> int:
    """Dynamic shared memory of one CTA of ``kernel`` ("fma", "decode"
    with ``rows`` per kv head and ``split_keys``, or "wgmma"), from the
    built library."""
    return _library().fa_smem_bytes(("fma", "decode", "wgmma").index(kernel),
                                    _DTYPE_CODE[dtype], head_dim, rows,
                                    split_keys)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_card_inputs(what: str, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> None:
    """Raise unless the kernels take these CUDA tensors: one dtype of
    `_DTYPE_CODE` and one device, ``Dh`` in `HEAD_DIMS`, contiguous, and
    none of them requiring grad under grad mode (`refuse_autograd`)."""
    refuse_autograd(what, q, k, v)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {q.dtype} is not float32 or bfloat16")
    if any(t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise TypeError(f"{what}: q, k, v differ in dtype or device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[-1]} has no kernel "
                         f"instance; built: {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{what}: non-contiguous input; the kernel reads "
                         "densely packed [B, H, T, Dh] arrays")


def _decode_scratch(B: int, Hkv: int, Tk: int, rows: int, Dh: int,
                    device: torch.device):
    """Keys per split and the decode kernel's float32 partials: per (b,
    kv head, split, row) m and l, then the Dh accumulator."""
    split_keys = decode_split_keys(B, Hkv, Tk, _sm_count(device))
    n_part = B * Hkv * -(-Tk // split_keys) * rows
    part = torch.empty(n_part * (2 + Dh), dtype=torch.float32, device=device)
    return split_keys, part, ctypes.c_void_p(part.data_ptr() + 4 * 2 * n_part)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None,
                         kernel: Optional[str] = None,
                         window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Attention over contiguous ``q [B, Hq, Tq, Dh]``, ``k/v [B, Hkv, Tk,
    Dh]``, float32 or bfloat16, ``Dh`` in `HEAD_DIMS`; ``window > 0`` a
    causal sliding window and ``softcap > 0`` a logit softcap, which all
    three kernels take.

    CPU tensors take `flash_attention_plain`; CUDA tensors launch the
    kernel `select_kernel` picks (nothing for an empty output) or raise.
    ``kernel`` ("decode", "wgmma" or "fma") names one instead, for timing
    and tests, and raises if that kernel does not take these inputs.
    Either counts as `kernels.work.flash_work` in a step count."""
    check_shapes(q, k, v)
    check_window(window, causal)
    with counted_flash(q, k, causal, window):
        return _flash_attention(q, k, v, causal, scale, kernel, window,
                                softcap)


def counted_flash(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int = 0) -> counting.kernel_call:
    """The count region of one attention call on ``q [B, Hq, Tq, Dh]``
    and ``k [B, Hkv, Tk, Dh]`` (`kernels.work.flash_work`), which the
    wrapper and the model code that calls it or its plain version
    enter."""
    return counting.kernel_call("flash_attention", lambda: flash_work(
        *q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
        causal, q.element_size(), window))


def _flash_attention(q, k, v, causal, scale, kernel, window, softcap):
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, softcap=softcap)
    _check_card_inputs("flash_attention", q, k, v)
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1:3]
    chosen = select_kernel(q, k) if kernel is None else kernel
    rows = (Hq // Hkv) * Tq
    if chosen not in KERNEL_COUNTERS:
        raise ValueError(f"flash_attention: unknown kernel {chosen!r}; "
                         f"one of {tuple(KERNEL_COUNTERS)}")
    if chosen == "decode" and rows > DECODE_MAX_ROWS:
        raise ValueError(f"flash_attention: the decode kernel takes at most "
                         f"{DECODE_MAX_ROWS} rows per kv head, not {rows}")
    if chosen == "wgmma" and (q.dtype != torch.bfloat16
                              or Dh not in WGMMA_HEAD_DIMS):
        raise ValueError(f"flash_attention: the wgmma kernel takes bfloat16 "
                         f"with head_dim in {WGMMA_HEAD_DIMS}, not {q.dtype} "
                         f"and {Dh}")
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    lib = _library()
    common = (B, Hq, Hkv, Tq, Tk, int(causal), int(window), float(scale),
              float(softcap))
    if chosen == "decode":
        split_keys, part, part_acc = _decode_scratch(B, Hkv, Tk, rows, Dh,
                                                     q.device)
        err = lib.fa_decode(_DTYPE_CODE[q.dtype], Dh, *common,
                            int(split_keys), *map(_ptr, (q, k, v, out, part)),
                            part_acc, stream)
    elif chosen == "wgmma":
        err = lib.fa_wgmma(Dh, *common, *map(_ptr, (q, k, v, out)), stream)
    else:
        err = lib.fa_attention(_DTYPE_CODE[q.dtype], Dh, *common,
                               *map(_ptr, (q, k, v, out)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {chosen} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES[KERNEL_COUNTERS[chosen]] += 1
    return out


# ---------------------------------------------------------------------------
# Decode against a KV cache read in place
# ---------------------------------------------------------------------------

def check_head_map(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   head_map) -> None:
    """Raise unless ``head_map`` (None, or a kv head index per q head)
    fits ``q [B, Hq, Tq, Dh]`` and ``k, v [B, Hkv, S, Dh]``."""
    if head_map is None:
        check_shapes(q, k, v)
        return
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "[B, Hq, Tq, Dh] and two equal [B, Hkv, S, Dh]")
    if len(head_map) != q.shape[1] or not all(
            0 <= h < k.shape[1] for h in head_map):
        raise ValueError(f"decode_attention: head map {tuple(head_map)} "
                         f"for {q.shape[1]} q heads and {k.shape[1]} kv "
                         "heads")


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length: torch.Tensor, *,
                           scale: Optional[float] = None,
                           softcap: float = 0.0, head_map=None,
                           return_lse: bool = False):
    """``q [B, Hq, Tq, Dh]`` against the cache ``k/v [B, Hkv, S, Dh]`` ->
    ``[B, Hq, Tq, Dh]`` in q's dtype: the reference's decode softmax, in
    float32 over all S rows with rows ``>= length`` masked by -1e30 (no
    causal mask), each GQA group's query rows against their kv head, or
    q head ``i`` against kv head ``head_map[i]`` where a map is given.
    ``softcap > 0`` caps the scores as ``softcap * tanh(s / softcap)``.
    ``return_lse``: also each row's log-sum-exp of its scaled scores over
    the keys, float32 ``[B, Hq, Tq]`` (-inf where ``length`` is 0)."""
    check_head_map(q, k_cache, v_cache, head_map)
    B, Hq, Tq, Dh = q.shape
    Hkv, S = k_cache.shape[1:3]
    if counting.shapes_only(q):
        out = torch.empty_like(q)   # counted by the kernel's formula
        return (out, q.new_empty((B, Hq, Tq), dtype=torch.float32)) \
            if return_lse else out
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    if head_map is None:
        qh = q.float().reshape(B, Hkv, (Hq // Hkv) * Tq, Dh)
        kh, vh = k_cache.float(), v_cache.float()
    else:
        idx = torch.tensor(head_map, device=q.device)
        qh = q.float()
        kh, vh = (c.index_select(1, idx).float() for c in (k_cache, v_cache))
    s = (qh @ kh.mT) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    n = length.reshape(())
    valid = torch.arange(S, device=q.device) < n
    s = torch.where(valid, s, s.new_tensor(_NEG_INF))
    out = (torch.softmax(s, dim=-1) @ vh).reshape(B, Hq, Tq, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq, Tq)
    return out, torch.where(n > 0, lse, lse.new_tensor(-float("inf")))


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length: torch.Tensor, *,
                          scale: Optional[float] = None,
                          softcap: float = 0.0, head_map=None,
                          return_lse: bool = False):
    """The split-K decode kernel on a cache read in place: contiguous ``q
    [B, Hq, Tq, Dh]`` (at most `DECODE_MAX_ROWS` rows ``group * Tq`` per
    kv head) against contiguous ``k/v [B, Hkv, S, Dh]``, of which the
    first ``min(length, S)`` rows are keys; ``length`` is a one-element
    int32 tensor on q's device, read by the kernel. float32 or bfloat16,
    ``Dh`` in `HEAD_DIMS`. Not causal: every valid row is a key of every
    query row. ``softcap > 0``: the logit softcap. A ``length`` of 0
    gives zeros (the plain version averages the masked buffer then); the
    model always writes before it reads. ``head_map`` (a sequence of
    ``Hq`` kv head indices): q head ``i`` reads kv head ``head_map[i]``,
    any map, at most `DECODE_MAX_ROWS` rows ``Tq`` times the most q
    heads of one kv head; a kv head no q head reads is not read.
    ``return_lse``: also each row's log-sum-exp of its scaled scores,
    float32 ``[B, Hq, Tq]`` (-inf where there is no key).

    CPU tensors take `decode_attention_plain`; CUDA tensors launch the
    kernel (one ``flash_attention_decode`` launch) or raise. Either
    counts as `kernels.work.decode_work` over the whole cache of the kv
    heads it reads in a step count (the keys it reads depend on
    ``length``, data that a count from shapes does not read)."""
    check_head_map(q, k_cache, v_cache, head_map)
    if length.numel() != 1 or length.dtype != torch.int32:
        raise TypeError(f"decode_attention: length must be one int32, not "
                        f"{length.dtype} of shape {tuple(length.shape)}")
    if head_map is not None:
        head_map = tuple(int(h) for h in head_map)
    with counted_decode(q, k_cache, head_map):
        return _decode_attention(q, k_cache, v_cache, length, scale,
                                 softcap, head_map, return_lse)


def counted_decode(q: torch.Tensor, k_cache: torch.Tensor, head_map=None
                   ) -> counting.kernel_call:
    """The count region of one decode call of ``q [B, Hq, Tq, Dh]``
    against the cache ``k [B, Hkv, S, Dh]`` (`kernels.work.decode_work`;
    with a ``head_map``, the kv heads it names), which the wrapper and the
    model code that calls it or its plain version enter."""
    Hkv = k_cache.shape[1] if head_map is None else len(set(head_map))
    return counting.kernel_call("decode_attention", lambda: decode_work(
        q.shape[0], q.shape[1] * q.shape[2], Hkv, k_cache.shape[2],
        q.shape[3], q.element_size()))


#: Device tables of head maps (`_head_table`), by (map, kv heads, device).
_HEAD_TABLES: Dict[tuple, tuple] = {}


def _head_table(head_map: tuple, Hkv: int, device: torch.device):
    """The kernel's form of a head map: (its width ``group``, the most q
    heads of one kv head; an int32 ``[Hkv, group]`` table on ``device`` of
    each kv head's q heads, -1 past them). Built once per map and device,
    so a decode step copies nothing to the card."""
    key = (head_map, Hkv, str(device))
    if key not in _HEAD_TABLES:
        served = [[i for i, h in enumerate(head_map) if h == kv]
                  for kv in range(Hkv)]
        group = max(len(s) for s in served)
        table = [s + [-1] * (group - len(s)) for s in served]
        _HEAD_TABLES[key] = (group, torch.tensor(
            table, dtype=torch.int32).to(device))
    return _HEAD_TABLES[key]


def _decode_attention(q, k_cache, v_cache, length, scale, softcap,
                      head_map=None, return_lse=False):
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, length,
                                      scale=scale, softcap=softcap,
                                      head_map=head_map,
                                      return_lse=return_lse)
    _check_card_inputs("decode_attention", q, k_cache, v_cache)
    if length.device != q.device:
        raise TypeError("decode_attention: length is not on q's device")
    B, Hq, Tq, Dh = q.shape
    Hkv, S = k_cache.shape[1:3]
    group, table = (Hq // Hkv, None) if head_map is None else _head_table(
        head_map, Hkv, q.device)
    rows = group * Tq
    if rows > DECODE_MAX_ROWS:
        raise ValueError(f"decode_attention: the decode kernel takes at most "
                         f"{DECODE_MAX_ROWS} rows per kv head, not {rows}")
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    lse = (torch.full((B, Hq, Tq), -float("inf"), dtype=torch.float32,
                      device=q.device) if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    split_keys, part, part_acc = _decode_scratch(B, Hkv, S, rows, Dh,
                                                 q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    null = ctypes.c_void_p(None)
    err = _library().fa_decode_cache(
        _DTYPE_CODE[q.dtype], Dh, B, Hq, Hkv, Tq, S, float(scale),
        float(softcap), int(split_keys), group if table is not None else 0,
        null if table is None else _ptr(table),
        *map(_ptr, (q, k_cache, v_cache, length, out)),
        null if lse is None else _ptr(lse), _ptr(part), part_acc, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention decode kernel launch failed "
                           f"(KV cache): CUDA error {err}")
    LAUNCHES[KERNEL_COUNTERS["decode"]] += 1
    return (out, lse) if return_lse else out
