"""Attention kernels of the FLUX path and their plain PyTorch twins.

* :func:`flash_attention` -- kernel ``csrc/flash_fixed.cu``, counterpart of
  ``nunchaku_tpu/ops/attention.py`` ``flash_attention`` as the FLUX path
  calls it (``fixed_softmax=True, out_bshd=True, scale=1.0``, no kv mask;
  ``_flash_kernel_fixed`` :403). Non-causal; q carries softmax-scale *
  log2(e), so the logits live in the log2 domain, and the softmax uses a
  fixed shift instead of a running max: ``p = 2^(min(s, 116) - 16)``,
  ``out = (bf16(p) @ v) / sum(p)``.
* :func:`qkv_rope_producer` -- kernel ``csrc/qkv_rope_producer.cu``,
  counterpart of ``qkv_rope_producer`` (:212, ``_qkv_rope_producer_kernel``
  :158): the fused attention prologue of the bf16-stream configuration
  (split, head transpose, optional low-rank add, q/k RMSNorm, half-split
  RoPE, q prescale), writing q, k, v in flash's (B, H, S, D) layout.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .reference import bf16_matmul

LOG2E = math.log2(math.e)
FIXED_SHIFT = 16.0
FIXED_CAP = 116.0
KERNEL_HEAD_DIM = 128
RMS_EPS = 1e-6


def rope_table_halfsplit(rot: torch.Tensor):
    """Interleaved rope table (S, D/2, 2) -> half-split (cos, sin), each
    (S, D) f32: cos repeats across both halves and sin's first half is
    negated, so ``out = a * cos + roll(a, D/2) * sin`` rotates the channel
    pairs (i, i + D/2)."""
    c, s = rot[..., 0], rot[..., 1]
    return torch.cat([c, c], dim=-1).contiguous(), torch.cat([-s, s], dim=-1).contiguous()


def _producer_outputs(qkv, heads, d, out, s_offset):
    b, s, _ = qkv.shape
    if out is None:
        out = tuple(torch.empty((b, heads, s, d), dtype=torch.bfloat16, device=qkv.device) for _ in range(3))
    _build.require(all(tuple(t.shape[:2]) == (b, heads) and t.shape[3] == d and t.dtype == torch.bfloat16
                       and t.is_contiguous() for t in out), "outputs must be contiguous (B, H, S_out, D) bf16")
    _build.require(0 <= s_offset and s_offset + s <= out[0].shape[2],
                   f"rows [{s_offset}, {s_offset + s}) do not fit S_out={out[0].shape[2]}")
    return out


def qkv_rope_producer_plain(qkv, cos, sin, norm_q, norm_k, *, q_scale=1.0, lora_act=None, proj_up=None,
                            out=None, s_offset=0):
    b, s, n3 = qkv.shape
    d = norm_q.shape[0]
    heads = n3 // 3 // d
    out = _producer_outputs(qkv, heads, d, out, s_offset)
    x = qkv.float()
    if lora_act is not None:
        x = x + bf16_matmul(lora_act.reshape(b, s, -1), proj_up)
    x = x.reshape(b, s, 3, heads, d).transpose(1, 3)  # (B, H, 3, S, D)
    c, sn = cos.float(), sin.float()  # (S, D)

    def prep(a, w, scale):
        ms = (a * a).mean(dim=-1, keepdim=True)
        a = a * torch.rsqrt((ms + RMS_EPS).double()).float() * w.float()
        o = a * c + torch.roll(a, d // 2, dims=-1) * sn
        return o * scale if scale != 1.0 else o

    rows = slice(s_offset, s_offset + s)
    out[0][:, :, rows] = prep(x[:, :, 0], norm_q, q_scale).to(torch.bfloat16)
    out[1][:, :, rows] = prep(x[:, :, 1], norm_k, 1.0).to(torch.bfloat16)
    out[2][:, :, rows] = x[:, :, 2].to(torch.bfloat16)
    return out


def qkv_rope_producer(qkv, cos, sin, norm_q, norm_k, *, q_scale=1.0, lora_act=None, proj_up=None,
                      out=None, s_offset=0):
    """(B, S, 3*H*D) fused-QKV GEMM output -> q, k, v, each (B, H, S, D) bf16.

    Per (token, head): ``a = x [+ bf16(lora_act) @ proj_up slice]``; for q
    and k ``a = a * rsqrt(mean(a^2) + 1e-6) * norm_w``, then the half-split
    rope ``a * cos + roll(a, D/2) * sin`` (cos / sin from
    :func:`rope_table_halfsplit`, rows of this call's tokens), and q times
    ``q_scale``; v gets only the low-rank add. Weights must be in half-split
    layout (``models.attention.permute_qk_halfsplit``).

    Shared-buffer mode: ``out = (q, k, v)`` given by the caller, (B, H,
    S_out, D), receive this call's rows at ``[s_offset, s_offset + S)`` --
    the dual block's txt and img streams fill one joint buffer set, with no
    concatenation (the JAX ``out_s`` / ``s_offset`` / ``alias_outs``)."""
    if not qkv.is_cuda:
        return qkv_rope_producer_plain(qkv, cos, sin, norm_q, norm_k, q_scale=q_scale, lora_act=lora_act,
                                       proj_up=proj_up, out=out, s_offset=s_offset)
    b, s, n3 = qkv.shape
    d = norm_q.shape[0]
    heads = n3 // 3 // d
    _build.require(d == KERNEL_HEAD_DIM and n3 == 3 * heads * d,
                   f"qkv producer kernel is built for head_dim {KERNEL_HEAD_DIM} (got {d}, 3HD={n3})")
    _build.require(qkv.dtype == torch.bfloat16 and qkv.is_contiguous(), "qkv: contiguous bf16")
    _build.require(cos.dtype == sin.dtype == torch.float32 and cos.is_contiguous() and sin.is_contiguous()
                   and tuple(cos.shape) == tuple(sin.shape) == (s, d), "cos/sin: contiguous (S, D) f32")
    _build.require(norm_q.dtype == norm_k.dtype == torch.bfloat16, "norm weights: bf16")
    out = _producer_outputs(qkv, heads, d, out, s_offset)
    r, la, pu = 0, None, None
    if lora_act is not None:
        r = lora_act.shape[-1]
        rp = -(-r // 16) * 16  # the kernel's WMMA tile takes R in steps of 16
        la = lora_act.float().reshape(b * s, r)
        pu = proj_up.to(torch.bfloat16)
        if rp != r:
            la = torch.nn.functional.pad(la, (0, rp - r))
            pu = torch.nn.functional.pad(pu, (0, 0, 0, rp - r))
        la, pu, r = la.contiguous(), pu.contiguous(), rp
        _build.require(r <= 32 and tuple(pu.shape) == (r, n3), "lora: rank <= 32 and proj_up (R, 3HD)")
    nq, nk = norm_q.contiguous(), norm_k.contiguous()
    lib = _build.library()
    _build.check(lib.nt_qkv_rope_producer(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), nq.data_ptr(), nk.data_ptr(),
        None if la is None else la.data_ptr(), None if pu is None else pu.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), b, s, heads, out[0].shape[2], s_offset, r,
        float(q_scale), torch.cuda.current_stream(qkv.device).cuda_stream), "qkv_rope_producer")
    qkv_rope_producer.launches += 1
    return out


qkv_rope_producer.launches = 0


def flash_attention_plain(q, k, v):
    b, h, sq, d = q.shape
    s = q.float() @ k.float().transpose(-1, -2)  # bf16 products are exact in f32
    p = torch.exp2(torch.clamp(s, max=FIXED_CAP) - FIXED_SHIFT)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(torch.bfloat16).float() @ v.float()) / l
    return o.to(q.dtype).transpose(1, 2).reshape(b, sq, h * d)


def flash_attention(q, k, v):
    """q (B, H, Sq, D) prescaled by softmax-scale * log2(e), k/v
    (B, H, Skv, D) bf16 -> (B, Sq, H*D)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"flash kernel is built for head_dim {KERNEL_HEAD_DIM}, got {d}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise ValueError("flash kernel takes bf16 q, k, v")
    if tuple(k.shape) != (b, h, skv, d) or tuple(v.shape) != (b, h, skv, d):
        raise ValueError("k and v must be (B, H, Skv, D) like q")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, sq, h * d), dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    _build.check(lib.nt_flash_fixed(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, h,
                                    sq, skv, torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_fixed")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
