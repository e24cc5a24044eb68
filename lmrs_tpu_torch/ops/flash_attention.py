"""Flash-attention prefill: the CUDA kernel ``csrc/flash_prefill.cu`` and
its plain PyTorch version.

Replaces the reference's Pallas ``flash_attention``
(``lmrs_tpu/ops/flash_attention.py:132``).  Routing rule of the port: a
CUDA tensor goes to the kernel, a CPU tensor to ``flash_attention_ref``;
there is no length gate (the reference's ``seq >= 256`` rule chose between
its kernel and XLA on the TPU — here every fresh or packed prefill on the
card runs the kernel) and no fallback: a kernel that cannot take the
inputs raises.

Contract: causal attention over fresh (position-0-based) sequences,
[B, S, H, hd] layout, GQA by ``h // (H // K)``, keys masked to
``k < lengths[b]``, optional same-segment mask for packed prompts, and
rows at positions >= ``lengths[b]`` equal to zero.
"""

from __future__ import annotations

import ctypes

import torch

from lmrs_tpu_torch.ops.attention import attention, packed_attention


def flash_attention_ref(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    lengths: torch.Tensor | None = None,      # [B] valid kv length
    segment_ids: torch.Tensor | None = None,  # [B, S] packed segments (pad -1)
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract."""
    b, s = q.shape[:2]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if segment_ids is None:
        positions = torch.arange(s, device=q.device).expand(b, s)
        out = attention(q, k, v, positions, lengths)
    else:
        out = packed_attention(q, k, v, segment_ids, lengths)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    return torch.where(valid[:, :, None, None], out, torch.zeros_like(out))


def _check_operand(name: str, t: torch.Tensor,
                   device: torch.device) -> None:
    if t.device != device or t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: {name} must be bfloat16 on "
                         f"{device} (got {t.dtype} on {t.device})")
    if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         "dim, strides in multiples of 8 and 16-byte "
                         "alignment")


def _flash_cuda(q, k, v, lengths, segment_ids) -> torch.Tensor:
    from lmrs_tpu_torch.ops import kernels

    b, s, h, hd = q.shape
    kh = k.shape[2]
    if k.shape != (b, s, kh, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    kernels.check_shapes("flash_attention", hd, h, kh)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"flash_attention: lengths must be [{b}]")
    seg_ptr, seg_sb = None, 0
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        if segment_ids.shape != (b, s):
            raise ValueError(f"flash_attention: segment_ids must be [{b}, {s}]")
        seg_ptr, seg_sb = segment_ids.data_ptr(), s
    out = torch.empty_like(q)
    fn = kernels.load("flash_prefill").lmrs_flash_prefill_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 13 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), seg_ptr, b, s, h, kh, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], seg_sb, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch("lmrs_flash_prefill_bf16", rc)
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    lengths: torch.Tensor | None = None,      # [B] valid kv length
    segment_ids: torch.Tensor | None = None,  # [B, S] packed segments (pad -1)
) -> torch.Tensor:
    """Causal flash prefill (see module doc).  Returns [B, S, H, hd] in
    q's dtype.  ``flash_attention.launches`` counts kernel launches."""
    if q.is_cuda:
        return _flash_cuda(q, k, v, lengths, segment_ids)
    return flash_attention_ref(q, k, v, lengths, segment_ids)


flash_attention.launches = 0
