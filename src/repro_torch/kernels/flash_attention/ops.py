"""Prefill flash attention (with its backward) and paged extend attention:
dispatch by device.

The wrappers take the model's (B, S, H, Dh) layout.  A CPU tensor takes
the plain version in ``ref.py``; a CUDA tensor launches the hand-written
kernel in ``csrc/flash_attention.cu`` or raises.  There is no fallback
from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import PLAIN_DEVICES
from repro_torch.kernels._paged import arena_args
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    flash_attention_bwd_ref,
    paged_extend_attention_ref,
)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, kv_len=None):
    """q: (B, Sq, Hq, Dh); k/v: (B, Skv, Hkv, Dh) -> (B, Sq, Hq, Dh).

    Any Sq; q positions align to the end of the keys, and a causal call
    needs Skv >= Sq (a bidirectional one takes any Skv).  ``kv_len``: an
    optional (B,) int32 key-length mask, key ``kp`` of row b counts iff
    ``kp < kv_len[b]`` (a row with none stores 0 on the card).  On the
    card the route is by dtype alone: bfloat16 launches the tensor-core
    kernel, which takes ``Dh % 16 == 0`` and ``Dh <= 256``; float32
    launches the CUDA-core kernel (the same packed rows and tiled walk,
    exact float32 products, each output summed in one fixed order), which
    takes ``Dh % 4 == 0`` and ``Dh <= 256``.  Any other head dim raises
    ``ValueError``; q, k and v whose rows do not start on 16 bytes are
    copied first.
    ``flash_attention.launches`` counts kernel launches,
    ``flash_attention.launches_tc`` those of the tensor-core kernel and
    ``flash_attention.launches_kv_len`` those under a key-length mask,
    by the call's ``(Sq, Skv)``.

    Differentiable: when grad is enabled and q, k or v requires it, the
    forward also writes each row's log-sum-exp and saves q, k, v, the
    output and the LSE for :func:`flash_attention_bwd` (on a CPU tensor
    ``ref.attention_ref`` with its LSE and ``ref.flash_attention_bwd_ref``).
    Under ``no_grad`` or ``inference_mode`` it is the serving launch, no
    LSE and nothing saved."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, kv_len)
    return _flash_forward(q, k, v, causal, window, kv_len, False)[0]


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        out, lse = _flash_forward(q, k, v, causal, window, kv_len, True)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.mask = (causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         kv_len=kv_len)
        return dq, dk, dv, None, None, None


def _flash_forward(q, k, v, causal, window, kv_len, with_lse: bool):
    """(out, the float32 (B, Hq, Sq) LSE when ``with_lse`` else None)."""
    if q.device.type in PLAIN_DEVICES:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            kv_len=kv_len, return_lse=with_lse)
        if with_lse:
            return out[0].transpose(1, 2), out[1]
        return out.transpose(1, 2), None
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Skv, Hkv, Dh) or v.shape != k.shape or Hq % Hkv
            or (causal and Skv < Sq)):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (causal={causal})")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype == torch.int8:
        raise ValueError("q, k and v must share one float dtype")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    kl = _kv_len_arg(kv_len, B, q.device)
    tc = q.dtype == torch.bfloat16
    step = 16 if tc else 4
    if Dh % step or Dh > 256:
        raise ValueError(f"the {q.dtype} flash kernel takes a head dim that "
                         f"is a multiple of {step} up to 256, not {Dh}")
    q, k, v = (_rows16(t) for t in (q, k, v))
    out = torch.empty((B, Sq, Hq, Dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _build.kernel("rt_flash_attention",
                       "PLLL PLLL PLLL PLLL IIIIIPIIII PP")
    rc = fn(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], out.data_ptr(), *out.stride()[:3],
            B, Hq, Hkv, Sq, Skv, _build.ptr(kl), Dh, int(causal),
            -1 if window is None else int(window),
            _build.DTYPE_CODE[q.dtype], _build.ptr(lse),
            _build.stream_ptr(q.device))
    flash_attention.launches += 1
    flash_attention.launches_tc += tc
    if kl is not None:
        flash_attention.launches_kv_len[Sq, Skv] = (
            flash_attention.launches_kv_len.get((Sq, Skv), 0) + 1)
    _build.check(rc, "flash_attention")
    return out, lse


def _kv_len_arg(kv_len, B: int, device):
    """The key-length mask as the kernels read it: (B,) int32 contiguous on
    ``device``, or None."""
    if kv_len is None:
        return None
    if kv_len.shape != (B,):
        raise ValueError("kv_len needs one entry per row")
    return kv_len.to(device=device, dtype=torch.int32).contiguous()


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_kv_len = {}
_build.count_launches(flash_attention, "launches", "launches_tc",
                      "launches_kv_len")


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None, kv_len=None):
    """The gradient of :func:`flash_attention`: (dq, dk, dv) in the shapes
    and dtypes of q, k, v, from the forward's ``out``, its cotangent
    ``dout`` (both (B, Sq, Hq, Dh)) and ``lse`` (B, Hq, Sq) float32, under
    the forward's masks.  A CPU tensor takes ``ref.flash_attention_bwd_ref``;
    a CUDA tensor launches the kernels of ``csrc/flash_attention_bwd.cu``,
    deterministic (no atomics), routed by dtype alone as the forward is:
    bfloat16 takes the tensor-core kernels, which take ``Dh % 16 == 0`` up
    to 256; float32 the CUDA-core kernels (exact float32 products), which
    take ``Dh % 4 == 0`` up to 256 and a float32 dS^T scratch of (B, Hkv,
    Skv, G Sq rounded up to 64) for the dQ pass; any other head dim raises
    ``ValueError``.  ``flash_attention_bwd.launches`` counts its calls on
    the card, ``flash_attention_bwd.launches_tc`` those on the tensor
    cores."""
    if q.device.type in PLAIN_DEVICES:
        g = flash_attention_bwd_ref(
            *(t.transpose(1, 2) for t in (q, k, v, out, dout)), lse,
            causal=causal, window=window, kv_len=kv_len)
        return tuple(t.transpose(1, 2) for t in g)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention backward for device {q.device}")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Skv, Hkv, Dh) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, Hq, Sq) or Hq % Hkv):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"out {tuple(out.shape)} dout {tuple(dout.shape)} "
                         f"lse {tuple(lse.shape)}")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != q.dtype for t in (k, v, out, dout))):
        raise ValueError("q, k, v, out and dout must share a float32 or "
                         "bfloat16 dtype")
    tc = q.dtype == torch.bfloat16
    step = 16 if tc else 4
    if Dh % step or Dh > 256:
        raise ValueError(f"the {q.dtype} flash backward takes a head dim "
                         f"that is a multiple of {step} up to 256, not {Dh}")
    q, k, v, out, dout = (_rows16(t if t.stride(-1) == 1 else t.contiguous())
                          for t in (q, k, v, out, dout))
    lse = lse.to(torch.float32).contiguous()
    kl = _kv_len_arg(kv_len, B, q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    D = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    # float32: dS^T of each kv head's packed (q position, q head) rows,
    # (B, Hkv, Skv, G Sq rounded up to 64), which the dQ pass reads
    rows = (Hq // Hkv * Sq + 63) // 64 * 64
    dsT = (None if tc else torch.empty((B, Hkv, Skv, rows),
                                       dtype=torch.float32, device=q.device))
    fn = _build.kernel("rt_flash_attention_bwd",
                       "PLLL PLLL PLLL PLLL PLLL PPP PLLL PLLL PLLL "
                       "IIIIIPIIII P")
    rc = fn(*(x for t in (q, k, v, out, dout)
              for x in (t.data_ptr(), *t.stride()[:3])),
            lse.data_ptr(), D.data_ptr(), _build.ptr(dsT),
            *(x for t in (dq, dk, dv) for x in (t.data_ptr(), *t.stride()[:3])),
            B, Hq, Hkv, Sq, Skv, _build.ptr(kl), Dh, int(causal),
            -1 if window is None else int(window),
            _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q.device))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_tc += tc
    _build.check(rc, "flash_attention_bwd")
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0
_build.count_launches(flash_attention_bwd, "launches", "launches_tc")


def _rows16(t):
    """``t`` itself if every row starts on 16 bytes (a 16-byte aligned base
    and strides of whole 16-byte units), as the kernels' 16-byte copies
    need; else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                      for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def paged_extend_attention(q, k_arena, v_arena, slot_pos, block_table, pos,
                           layer: int, *, k_scale=None, v_scale=None):
    """q: (B, S, Hq, Dh) suffix queries at absolute positions pos[b] + i
    vs a paged arena (see ``paged_decode_attention``) -> (B, S, Hq, Dh).

    On the card the route is by the dtype of q: bfloat16 q, over a
    bfloat16 or an int8 arena, launches the tensor-core kernel, which
    takes ``Dh % 16 == 0`` up to 256 and an arena whose rows start on 16
    bytes (a 16-byte aligned base and strides that are multiples of 16
    bytes); either failing raises ``ValueError``.  float32 q, over a
    float32 or an int8 arena, launches the CUDA-core kernel (prefill
    flash's float32 body over the pages, exact float32 products), which
    takes ``Dh % 4 == 0`` up to 256 (else ``ValueError``) and any arena
    view: rows off 16 bytes are read element by element.
    ``paged_extend_attention.launches`` counts kernel launches,
    ``paged_extend_attention.launches_tc`` those of the tensor-core
    kernel."""
    layer = int(layer)
    if q.device.type in PLAIN_DEVICES:
        return paged_extend_attention_ref(
            q.transpose(1, 2), k_arena, v_arena, slot_pos, block_table, pos,
            layer, k_scale=k_scale, v_scale=v_scale).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"no paged extend kernel for device {q.device}")
    B, S, Hq, Dh = q.shape
    N, P, _L, Hkv, _ = k_arena.shape
    arena, scales, bt = arena_args(q, k_arena, v_arena, slot_pos,
                                   block_table, layer, k_scale, v_scale)
    if bt.shape[0] != B or pos.shape != (B,):
        raise ValueError("block_table and pos need one row per query row")
    ps = pos.to(device=q.device, dtype=torch.int32).contiguous()
    tc = q.dtype == torch.bfloat16
    step = 16 if tc else 4
    if Dh % step or Dh > 256:
        raise ValueError(f"the {q.dtype} paged extend kernel takes a head "
                         f"dim that is a multiple of {step} up to 256, not "
                         f"{Dh}")
    if tc:
        row = 16 // k_arena.element_size()   # elements in 16 bytes
        if any(t.data_ptr() % 16 or any(s % row for s in t.stride()[:4])
               for t in (k_arena, v_arena)):
            raise ValueError(f"the bfloat16 paged extend kernel needs "
                             f"{k_arena.dtype} arena rows that start on 16 "
                             f"bytes (a 16-byte aligned base and strides "
                             f"that are multiples of {row})")
    q = _rows16(q)
    out = torch.empty((B, S, Hq, Dh), dtype=q.dtype, device=q.device)
    fn = _build.kernel("rt_paged_extend_attention",
                       "PLLLI PPI LLLL PLLL PLI PI PPLL PLLL IIIIIII P")
    rc = fn(q.data_ptr(), *q.stride()[:3], _build.DTYPE_CODE[q.dtype],
            *arena, ps.data_ptr(), layer, *scales,
            out.data_ptr(), *out.stride()[:3],
            B, Hq, Hkv, S, Dh, N, P, _build.stream_ptr(q.device))
    paged_extend_attention.launches += 1
    paged_extend_attention.launches_tc += tc
    _build.check(rc, "paged_extend_attention")
    return out


paged_extend_attention.launches = 0
paged_extend_attention.launches_tc = 0
_build.count_launches(paged_extend_attention, "launches", "launches_tc")
