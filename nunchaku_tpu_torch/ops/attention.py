"""Attention kernels of the FLUX path and their plain PyTorch twins.

* :func:`flash_attention` -- kernel ``csrc/flash_fixed.cu``, counterpart of
  ``nunchaku_tpu/ops/attention.py`` ``flash_attention`` as the FLUX and
  Qwen-Image paths call it (``fixed_softmax=True, out_bshd=True,
  scale=1.0``; ``_flash_kernel_fixed`` :403), with or without ``kv_mask``.
  Non-causal; q carries softmax-scale * log2(e), so the logits live in the
  log2 domain, and the softmax uses a fixed shift instead of a running max:
  ``p = 2^(min(s + mask, 116) - 16)``, ``out = (bf16(p) @ v) / sum(p)``.
* :func:`qkv_rope_producer` -- kernel ``csrc/qkv_rope_producer.cu``,
  counterpart of ``qkv_rope_producer`` (:212, ``_qkv_rope_producer_kernel``
  :158): the fused attention prologue of the bf16-stream configuration
  (split, head transpose, optional low-rank add, q/k RMSNorm, half-split
  RoPE, q prescale), writing q, k, v in flash's (B, H, S, D) layout.
* :func:`qkv_prepare` -- the prepare mode of the same kernel, counterpart of
  ``qkv_prepare`` (:87, ``_qkv_prepare_kernel`` :51): the producer without
  the low-rank term, whole outputs, ``eps`` an argument. Count
  ``qkv_prepare``; no model path calls it, as in JAX.
* :func:`flash_attention_online` -- kernel ``csrc/flash_online.cu``,
  counterpart of ``flash_attention`` with ``fixed_softmax=False``
  (``_flash_kernel`` :607): the running-max softmax the VAE's single-head
  mid-block attention takes (D = 512, (B, H, S, D) out), SDXL's self- and
  cross-attention (D = 64, scale 1/sqrt(64), (B, S, H*D) out), SANA's
  cross-attention (D = 112, scale 1/sqrt(112), (B, S, H*D) out), and the
  FLUX / Qwen-Image attention under ``fixed_softmax = False`` (D = 128,
  (B, S, H*D) out, with or without ``kv_mask``).

* :func:`block_sparse_attention` -- the block-sparse forms of both flash
  kernels (``IDX`` mode of ``csrc/flash_fixed.cu`` and ``csrc/flash_online.cu``),
  counterpart of ``block_sparse_attention`` (:1241; ``_bs_kernel_fixed``
  :1109, ``_bs_kernel`` :1153): FLUX's high-resolution attention, each query
  block attending only to the kv blocks :func:`select_blocks` (:1204) picks
  by mean-pooled score. The selection is torch ops, as it is XLA ops in JAX,
  and its ids stay on the card.

* :func:`flash_attention_denom` -- the ``DENOM`` mode of ``csrc/flash_fixed.cu``,
  counterpart of ``flash_attention(..., fixed_softmax=True,
  return_denom=True)`` (``_flash_kernel_fixed_denom`` :461): o in (B, H, S,
  D) and the f32 row sums l = sum p, the step of the ring attention
  (``parallel/sp.py``). Count ``flash_fixed_denom``.
* :func:`flash_attention_unroll2` -- the two-tile mode (``U = 2``) of
  ``csrc/flash_fixed.cu``, counterpart of ``flash_attention(...,
  fixed_softmax=True, kv_unroll=2)`` (``_flash_kernel_fixed2`` :508), which
  :func:`flash_attention` takes for ``kv_unroll=2`` without a kv mask. Count
  ``flash_fixed_unroll2``.
* :func:`quantize_qk` (torch ops, XLA ops in JAX :974) and
  :func:`flash_attention_i8` -- kernel ``csrc/flash_fixed_i8.cu`` (the int8
  form of the attention core), counterpart of ``flash_attention_i8`` (:994,
  ``_flash_kernel_fixed_i8`` :563): int8 q . k with per-token scales, bf16
  p . v. Count ``flash_fixed_i8``.
* :func:`flash_attention_bshd` -- the token-major mode of ``csrc/flash_online.cu``,
  counterpart of ``flash_attention_bshd`` (:848, ``_flash_kernel_bshd``
  :927): q, k, v and the output (B, S, H, D), each head read and written
  with a row stride of H*D, no transposed copy on either side. Count
  ``flash_online_bshd``; no model path calls it, as in JAX.

``kv_mask`` is the JAX ``flash_attention``'s: (B, S_kv), bool (True =
attend) or an f32 additive log2-domain bias. The mask forms of both kernels
count their launches apart (``flash_fixed_masked``, ``flash_online_masked``
in :data:`MASKED_COUNTS`), and so do the block-sparse forms (``bs_fixed``,
``bs_online`` in :data:`BS_COUNTS`) and the online kernel at head dims 64
and 112 (``flash_online_d64`` and ``flash_online_d112`` in
:data:`ONLINE_DIM_COUNTS`), so SDXL's and SANA's launches stay apart from
the VAE's D-512 ones.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from . import _build
from .quantize import rcp
from .reference import RCP127, bf16_matmul

LOG2E = math.log2(math.e)
FIXED_SHIFT = 16.0
FIXED_CAP = 116.0
KERNEL_HEAD_DIM = 128
RMS_EPS = 1e-6
NEG_INF = -1e30
ONLINE_HEAD_DIMS = (64, 112, 128, 256, 512)  # the online kernel's instantiations
ONLINE_BKV = 128  # the kv tile of the Hopper attention core (head dims 64-128): the online rescale steps
WIDE_BKV = 64  # the kv tile of the wide kernel (head dims 256 and 512)
WIDE_BQ = 64  # its query rows a block
WIDE_SPLIT_SMS = 132  # the H100's SMs: the wide kernel splits the kv range while its query blocks fill half of them
WIDE_MAX_SPLITS = 4
MASKED_COUNTS = {"flash_fixed_masked": SimpleNamespace(launches=0),
                 "flash_online_masked": SimpleNamespace(launches=0)}
# the online kernel at head dim 64 (SDXL) and 112 (SANA), each counted apart
ONLINE_DIM_COUNTS = {64: SimpleNamespace(launches=0), 112: SimpleNamespace(launches=0)}
BS_COUNTS = {"bs_fixed": SimpleNamespace(launches=0), "bs_online": SimpleNamespace(launches=0)}
# the fixed-shift kernel's denominator and two-tile forms, and its int8 counterpart
FIXED_FORM_COUNTS = {name: SimpleNamespace(launches=0)
                     for name in ("flash_fixed_denom", "flash_fixed_unroll2", "flash_fixed_i8")}
UNROLL_TILE = 64  # the kv tile of the fixed-shift kernels: a two-tile step covers 128 columns
POOL_SIZE = 128  # the JAX select_blocks' default window (the reference's mask granularity)
BS_TILE = 128  # bq and bkv of the block-sparse kernels are multiples of this


def kv_bias(kv_mask: torch.Tensor, b: int, skv: int) -> torch.Tensor:
    """(B, S_kv) kv mask -> contiguous f32 additive log2-domain bias: a bool
    mask becomes 0 (attend) / -1e30, as the JAX ``flash_attention`` (:789-799)
    converts it; an additive one is cast to f32."""
    if kv_mask.dtype == torch.bool:
        bias = torch.where(kv_mask, 0.0, NEG_INF).to(torch.float32)
    else:
        bias = kv_mask.float()
    _build.require(tuple(bias.shape) == (b, skv), f"kv_mask must be (B, S_kv) = ({b}, {skv}), "
                                                  f"got {tuple(bias.shape)}")
    return bias.contiguous()


def _tiled_bias(bias: torch.Tensor) -> torch.Tensor:
    """(B, S_kv) f32 bias -> rows padded with -1e30 to a whole number of the
    attention core's kv tiles: the kernels copy a tile's bias beside its k."""
    pad = -bias.shape[1] % ONLINE_BKV
    return torch.nn.functional.pad(bias, (0, pad), value=NEG_INF).contiguous() if pad else bias


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
                            out=None, s_offset=0, eps=RMS_EPS):
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
        a = a * torch.rsqrt((ms + eps).double()).float() * w.float()
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
        rp = -(-r // 16) * 16  # the kernel's wgmma k step is 16 ranks
        la = lora_act.float().reshape(b * s, r)
        pu = proj_up.to(torch.bfloat16)
        if rp != r:
            la = torch.nn.functional.pad(la, (0, rp - r))
            pu = torch.nn.functional.pad(pu, (0, 0, 0, rp - r))
        la, pu, r = _aligned16(la), _aligned16(pu), rp
        _build.require(tuple(pu.shape) == (r, n3), "lora: proj_up must be (R, 3HD)")
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


def _prepare_heads(qkv, heads, head_dim):
    if qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv last dim {qkv.shape[-1]} != 3*{heads}*{head_dim}")


def qkv_prepare_plain(qkv, cos, sin, norm_q, norm_k, *, heads, head_dim, q_scale=1.0, eps=RMS_EPS):
    """:func:`qkv_rope_producer_plain` without the low-rank term, at ``eps``."""
    _prepare_heads(qkv, heads, head_dim)
    return qkv_rope_producer_plain(qkv, cos, sin, norm_q, norm_k, q_scale=q_scale, eps=eps)


def qkv_prepare(qkv, cos, sin, norm_q, norm_k, *, heads, head_dim, q_scale=1.0, eps=RMS_EPS):
    """(B, S, 3*H*D) fused-QKV GEMM output -> q, k, v, each (B, H, S, D)
    bf16 at any S: per (token, head) q and k ``a * rsqrt(mean(a^2) + eps) *
    norm_w``, the half-split rope ``a * cos + roll(a, D/2) * sin`` (cos / sin
    (S, D) f32 from :func:`rope_table_halfsplit`), q times ``q_scale``; v
    split only. On the card head dim 128."""
    if not qkv.is_cuda:
        return qkv_prepare_plain(qkv, cos, sin, norm_q, norm_k, heads=heads, head_dim=head_dim, q_scale=q_scale,
                                 eps=eps)
    _prepare_heads(qkv, heads, head_dim)
    b, s, _ = qkv.shape
    d = head_dim
    _build.require(d == KERNEL_HEAD_DIM and tuple(norm_q.shape) == tuple(norm_k.shape) == (d,),
                   f"qkv prepare kernel is built for head_dim {KERNEL_HEAD_DIM} (got {d}), norm weights (D,)")
    _build.require(qkv.dtype == torch.bfloat16 and qkv.is_contiguous(), "qkv: contiguous bf16")
    _build.require(cos.dtype == sin.dtype == torch.float32 and cos.is_contiguous() and sin.is_contiguous()
                   and tuple(cos.shape) == tuple(sin.shape) == (s, d), "cos/sin: contiguous (S, D) f32")
    _build.require(norm_q.dtype == norm_k.dtype == torch.bfloat16, "norm weights: bf16")
    out = tuple(torch.empty((b, heads, s, d), dtype=torch.bfloat16, device=qkv.device) for _ in range(3))
    nq, nk = norm_q.contiguous(), norm_k.contiguous()
    lib = _build.library()
    _build.check(lib.nt_qkv_prepare(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), nq.data_ptr(), nk.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), b, s, heads, float(q_scale), float(eps),
        torch.cuda.current_stream(qkv.device).cuda_stream), "qkv_prepare")
    qkv_prepare.launches += 1
    return out


qkv_prepare.launches = 0


def flash_attention_plain(q, k, v, kv_mask=None):
    b, h, sq, d = q.shape
    s = q.float() @ k.float().transpose(-1, -2)  # bf16 products are exact in f32
    if kv_mask is not None:
        s = s + kv_bias(kv_mask, b, k.shape[2])[:, None, None, :]
    p = torch.exp2(torch.clamp(s, max=FIXED_CAP) - FIXED_SHIFT)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(torch.bfloat16).float() @ v.float()) / l
    return o.to(q.dtype).transpose(1, 2).reshape(b, sq, h * d)


def _fixed_operands(q, k, v):
    """The fixed-shift kernels' checks of bf16 q (B, H, Sq, D), k, v (B, H,
    Skv, D) at head dim 128 -> contiguous q, k, v."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    _build.require(d == KERNEL_HEAD_DIM, f"flash kernel is built for head_dim {KERNEL_HEAD_DIM}, got {d}")
    _build.require(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "flash kernel takes bf16 q, k, v")
    _build.require(tuple(k.shape) == tuple(v.shape) == (b, h, skv, d) and skv > 0,
                   "k and v must be (B, H, Skv, D) like q, Skv > 0")
    return _aligned16(q), _aligned16(k), _aligned16(v)


def _heads_out(o, out_bshd):
    """(B, H, S, D) -> (B, S, H*D) when ``out_bshd``."""
    b, h, s, d = o.shape
    return o.transpose(1, 2).reshape(b, s, h * d) if out_bshd else o


def flash_attention(q, k, v, kv_mask=None, kv_unroll=1):
    """q (B, H, Sq, D) prescaled by softmax-scale * log2(e), k/v
    (B, H, Skv, D) bf16, optional (B, Skv) ``kv_mask`` -> (B, Sq, H*D).
    ``kv_unroll=2`` without a kv mask takes the two-tile form
    (:func:`flash_attention_unroll2`); with a mask, or any other value, the
    one-tile kernel runs, as JAX's gate rules have it (:713-722)."""
    if kv_unroll == 2 and kv_mask is None:
        return flash_attention_unroll2(q, k, v, scale=1.0, out_bshd=True)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, kv_mask)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    qc, kc, vc = _fixed_operands(q, k, v)
    bias = None if kv_mask is None else _tiled_bias(kv_bias(kv_mask.to(q.device), b, skv))
    out = torch.empty((b, sq, h * d), dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    _build.check(lib.nt_flash_fixed(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                    None if bias is None else bias.data_ptr(), out.data_ptr(), b, h,
                                    sq, skv, torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_fixed")
    (flash_attention if bias is None else MASKED_COUNTS["flash_fixed_masked"]).launches += 1
    return out


flash_attention.launches = 0


def _logit_scale(scale, d) -> float:
    """The factor on f32(q . k): scale * log2(e), or 1 when ``scale == 1``
    means q already carries it (the JAX convention); rounded to f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return float(torch.tensor(1.0 if scale == 1.0 else scale * LOG2E, dtype=torch.float32))


def _fixed_p(s, c):
    """Logits ``s`` (f32 q . k) times ``c`` -> the fixed-shift p in f32."""
    if c != 1.0:
        s = s * c
    return torch.exp2(torch.clamp(s, max=FIXED_CAP) - FIXED_SHIFT)


def flash_attention_denom_plain(q, k, v, scale=None):
    c = _logit_scale(scale, q.shape[-1])
    p = _fixed_p(q.float() @ k.float().transpose(-1, -2), c)
    l = p.sum(dim=-1)
    o = (p.to(torch.bfloat16).float() @ v.float()) / l[..., None]
    return o.to(q.dtype), l


def flash_attention_denom(q, k, v, *, scale=None, kv_mask=None, out_bshd=False):
    """Fixed-shift flash that also returns its softmax denominator: bf16 q
    (B, H, Sq, D), k, v (B, H, Skv, D) -> (o (B, H, Sq, D) bf16, l (B, H, Sq)
    f32), o = sum_k p v / l with l = sum_k p, p = 2^(min(s, 116) - 16).
    ``scale`` None means 1/sqrt(D), 1.0 that q already carries scale *
    log2(e). Partial results over disjoint kv shards combine exactly
    (``parallel.sp.combine_shard``). No kv mask and no (B, S, H*D) output:
    both raise, as the JAX package's assert (:715-719)."""
    _build.require(kv_mask is None and not out_bshd,
                   "the denominator form takes no kv mask and writes (B, H, S, D) (return_denom)")
    if not q.is_cuda:
        return flash_attention_denom_plain(q, k, v, scale)
    b, h, sq, d = q.shape
    qc, kc, vc = _fixed_operands(q, k, v)
    out = torch.empty((b, h, sq, d), dtype=torch.bfloat16, device=q.device)
    lsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    _build.check(lib.nt_flash_fixed_denom(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                                          lsum.data_ptr(), b, h, sq, k.shape[2], _logit_scale(scale, d),
                                          torch.cuda.current_stream(q.device).cuda_stream), "flash_fixed_denom")
    FIXED_FORM_COUNTS["flash_fixed_denom"].launches += 1
    return out, lsum


def flash_attention_unroll2_plain(q, k, v, scale=None, out_bshd=False, tile=UNROLL_TILE):
    """The two-tile kernel's steps in torch ops: per step of two ``tile``
    column tiles (cut at Skv: a cut column's p is exactly 0 in the kernel),
    ``l += sum p1 + sum p2`` and ``acc += bf16(p1) @ v1 + bf16(p2) @ v2``."""
    c = _logit_scale(scale, q.shape[-1])
    qf = q.float()
    l = torch.zeros(q.shape[:-1] + (1,), dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(0, k.shape[2], 2 * tile):
        ps, pv = [], []
        for j0 in (j, j + tile):
            p = _fixed_p(qf @ k[:, :, j0:j0 + tile].float().transpose(-1, -2), c)
            ps.append(p.sum(dim=-1, keepdim=True))
            pv.append(p.to(torch.bfloat16).float() @ v[:, :, j0:j0 + tile].float())
        l = l + (ps[0] + ps[1])
        acc = acc + (pv[0] + pv[1])
    return _heads_out((acc / l).to(q.dtype), out_bshd)


def flash_attention_unroll2(q, k, v, *, scale=None, out_bshd=False):
    """Fixed-shift flash over two kv tiles a main-loop step (both tiles'
    q . k before the first tile's exp2 pass): bf16 q (B, H, Sq, D), k, v
    (B, H, Skv, D) -> (B, H, Sq, D), or (B, Sq, H*D) with ``out_bshd``;
    ``scale`` as :func:`flash_attention_denom`'s."""
    if not q.is_cuda:
        return flash_attention_unroll2_plain(q, k, v, scale, out_bshd)
    b, h, sq, d = q.shape
    qc, kc, vc = _fixed_operands(q, k, v)
    out = torch.empty((b, sq, h * d) if out_bshd else (b, h, sq, d), dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    _build.check(lib.nt_flash_fixed_unroll2(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, h, sq,
                                            k.shape[2], int(out_bshd), _logit_scale(scale, d),
                                            torch.cuda.current_stream(q.device).cuda_stream), "flash_fixed_unroll2")
    FIXED_FORM_COUNTS["flash_fixed_unroll2"].launches += 1
    return out


def quantize_qk(q, k):
    """Per-(batch, head, token) int8 codes of q and k (JAX ``quantize_qk``
    :974): ``scale = max |t| * f32(1/127)`` (XLA's form of ``/ 127.0``),
    ``t8 = clip(round(t * rcp(scale)), -127, 127)`` -> (q8, qs, k8, ks), the
    scales (B, H, S) f32."""
    def one(t):
        tf = t.float()
        scale = tf.abs().amax(dim=-1) * RCP127
        return torch.clamp(torch.round(tf * rcp(scale)[..., None]), -127, 127).to(torch.int8), scale

    q8, qs = one(q)
    k8, ks = one(k)
    return q8, qs, k8, ks


def tiled_scales(ks: torch.Tensor) -> torch.Tensor:
    """(B, H, Skv) column scales -> f32, each row padded with zeros to a
    whole number of the attention core's kv tiles: the int8 kernel copies a
    tile's 128 scales beside its k (JAX pads ks with zeros to whole kv
    blocks too)."""
    pad = -ks.shape[-1] % ONLINE_BKV
    ks = ks.float()
    return torch.nn.functional.pad(ks, (0, pad)) if pad else ks


def flash_attention_i8_plain(q8, qs, k8, ks, v, out_bshd=False):
    """``ks`` may carry padding past Skv (:func:`tiled_scales`): only its
    first Skv columns are read, as in the kernel."""
    s = q8.float() @ k8.float().transpose(-1, -2)  # integers below 2^24: exact in f32
    ks = ks[..., :k8.shape[2]]
    p = _fixed_p((s * qs[..., None].float()) * ks[..., None, :].float(), 1.0)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(torch.bfloat16).float() @ v.float()) / l
    return _heads_out(o.to(v.dtype), out_bshd)


def flash_attention_i8(q8, qs, k8, ks, v, *, out_bshd=False):
    """Fixed-shift flash with int8 q . k: q8 (B, H, Sq, D) int8 with scales
    qs (B, H, Sq), k8 / ks likewise over Skv, v (B, H, Skv, D) bf16 ->
    (B, H, Sq, D) bf16, or (B, Sq, H*D) with ``out_bshd``. Logits ``(f32(q8
    . k8) * qs_i) * ks_j`` (q prescaled before :func:`quantize_qk`)."""
    if not q8.is_cuda:
        return flash_attention_i8_plain(q8, qs, k8, ks, v, out_bshd)
    b, h, sq, d = q8.shape
    skv = k8.shape[2]
    _build.require(d == KERNEL_HEAD_DIM, f"int8 flash kernel is built for head_dim {KERNEL_HEAD_DIM}, got {d}")
    _build.require(q8.dtype == k8.dtype == torch.int8 and v.dtype == torch.bfloat16, "int8 q8, k8; bf16 v")
    _build.require(tuple(k8.shape) == tuple(v.shape) == (b, h, skv, d), "k8 and v must be (B, H, Skv, D) like q8")
    _build.require(tuple(qs.shape) == (b, h, sq) and tuple(ks.shape) == (b, h, skv), "qs (B, H, Sq), ks (B, H, Skv)")
    qc, kc, vc = _aligned16(q8), _aligned16(k8), _aligned16(v)
    qsc, ksc = qs.float().contiguous(), tiled_scales(ks).contiguous()
    out = torch.empty((b, sq, h * d) if out_bshd else (b, h, sq, d), dtype=torch.bfloat16, device=v.device)
    lib = _build.library()
    _build.check(lib.nt_flash_fixed_i8(qc.data_ptr(), qsc.data_ptr(), kc.data_ptr(), ksc.data_ptr(), vc.data_ptr(),
                                       out.data_ptr(), b, h, sq, skv, int(out_bshd),
                                       torch.cuda.current_stream(v.device).cuda_stream), "flash_fixed_i8")
    FIXED_FORM_COUNTS["flash_fixed_i8"].launches += 1
    return out


def online_tile(d: int) -> int:
    """The online kernel's kv tile at head dim ``d``: the columns between
    two rescales (the core's 128 up to D 128, the wide kernel's 64 above)."""
    return ONLINE_BKV if d <= KERNEL_HEAD_DIM else WIDE_BKV


def online_splits(b: int, h: int, sq: int, skv: int, d: int) -> int:
    """The kv ranges the online kernel splits one query block's work into at
    head dim ``d`` (``csrc/flash_online.cu`` ``wide_splits``): 1 on the core
    (D <= 128); above, 2 or 4 while the B * H * ceil(Sq / 64) query blocks,
    so multiplied, fit at most once on the card's 132 SMs (and each range
    keeps at least one 64-column tile)."""
    if d <= KERNEL_HEAD_DIM:
        return 1
    blocks = b * h * -(-sq // WIDE_BQ)
    nt = -(-skv // WIDE_BKV)
    ns = 1
    while ns < WIDE_MAX_SPLITS and blocks * ns * 2 <= WIDE_SPLIT_SMS and nt >= ns * 2:
        ns *= 2
    return ns


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor whose data starts on a 16-byte boundary, as the
    attention core's tensor maps and the qkv producer's 16-byte copies need
    (a copy only for a view that does not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _online_run(qf, k, v, c, bkv, bias, j0, j1):
    """The online recurrence over kv columns [j0, j1) in chunks of ``bkv``
    from column j0 -> the running (m, l, acc) in f32."""
    b, h, sq, d = qf.shape
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qf.device)
    for j in range(j0, j1, bkv):
        e = min(j + bkv, j1)
        s = (qf @ k[:, :, j:e].float().transpose(-1, -2)) * c
        if bias is not None:
            s = s + bias[..., j:e]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2((s - m_new).to(torch.bfloat16).float()).to(torch.bfloat16).float()
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v[:, :, j:e].float()
        m = m_new
    return m, l, acc


def _online_plain(q, k, v, c, bkv, bias=None, splits=1):
    """The online recurrence over (B, H, S, D) q, k, v with logit factor
    ``c`` and kv chunks of ``bkv`` columns -> (B, H, Sq, D) bf16. The last
    chunk is cut at Skv instead of masked: a masked tail column's p is
    exactly 0 and never the row max, so the two agree. With ``splits`` > 1
    the ceil(Skv / bkv) chunks are cut into that many contiguous ranges (range
    r: chunks [r n / splits, (r + 1) n / splits)), each run from a fresh (m,
    l, acc), then merged as the wide kernel merges them: M = max m_r, a_r =
    2^(m_r - M), out = bf16(sum_r acc_r a_r / sum_r l_r a_r), sums in range
    order."""
    qf = q.float()
    skv = k.shape[2]
    if splits == 1:
        _, l, acc = _online_run(qf, k, v, c, bkv, bias, 0, skv)
        return (acc / l).to(torch.bfloat16)
    nt = -(-skv // bkv)
    parts = [_online_run(qf, k, v, c, bkv, bias, r * nt // splits * bkv, min((r + 1) * nt // splits * bkv, skv))
             for r in range(splits)]
    big_m = parts[0][0]
    for m_r, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m_r)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m_r, l_r, acc_r in parts:
        a = torch.exp2(m_r - big_m)
        l = l + l_r * a
        acc = acc + acc_r * a
    return (acc / l).to(torch.bfloat16)


def flash_attention_online_plain(q, k, v, scale=None, bkv=None, kv_mask=None, out_bshd=False, splits=None):
    """The kernel's recurrence in torch ops, over kv chunks of ``bkv``
    columns (the kernel's tile at this head dim by default,
    :func:`online_tile`, so the rescales fall where the kernel's do), in
    ``splits`` merged kv ranges (the kernel's, :func:`online_splits`, by
    default; with ``bkv`` given, one unless ``splits`` is given too)."""
    b, h, sq, d = q.shape
    if splits is None:
        splits = online_splits(b, h, sq, k.shape[2], d) if bkv is None else 1
    bkv = online_tile(d) if bkv is None else bkv
    bias = None if kv_mask is None else kv_bias(kv_mask, b, k.shape[2])[:, None, None, :]
    return _heads_out(_online_plain(q, k, v, _logit_scale(scale, d), bkv, bias, splits), out_bshd)


def flash_attention_online(q, k, v, scale=None, kv_mask=None, out_bshd=False):
    """Non-causal attention with a running-max softmax over (B, H, S, D)
    bf16 q, k, v, optional (B, Skv) ``kv_mask`` (head dims 64, 112, 128, 256
    and 512 on the card, the mask form at 128 only)
    -> (B, H, Sq, D) bf16, or (B, Sq, H*D) with ``out_bshd``; ``scale``
    defaults to 1/sqrt(D), and ``scale=1.0`` means q already carries
    scale * log2(e)."""
    if not q.is_cuda:
        return flash_attention_online_plain(q, k, v, scale, kv_mask=kv_mask, out_bshd=out_bshd)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    _build.require(d in ONLINE_HEAD_DIMS, f"online flash kernel is built for head dims {ONLINE_HEAD_DIMS}, got {d}")
    _build.require(kv_mask is None or d == KERNEL_HEAD_DIM,
                   f"the online kernel's mask form is built for head dim {KERNEL_HEAD_DIM}, got {d}")
    _build.require(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "online flash kernel takes bf16 q, k, v")
    _build.require(tuple(k.shape) == tuple(v.shape) == (b, h, skv, d) and skv > 0,
                   "k and v must be (B, H, Skv, D) like q, Skv > 0")
    qc, kc, vc = (_aligned16(t) for t in (q, k, v))
    bias = None if kv_mask is None else _tiled_bias(kv_bias(kv_mask.to(q.device), b, skv))
    shape = (b, sq, h * d) if out_bshd else (b, h, sq, d)
    out = torch.empty(shape, dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    _build.check(lib.nt_flash_online(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                     None if bias is None else bias.data_ptr(), out.data_ptr(), b, h, sq,
                                     skv, d, int(out_bshd), _logit_scale(scale, d),
                                     torch.cuda.current_stream(q.device).cuda_stream), "flash_online")
    if bias is not None:
        MASKED_COUNTS["flash_online_masked"].launches += 1
    else:
        ONLINE_DIM_COUNTS.get(d, flash_attention_online).launches += 1
    return out


flash_attention_online.launches = 0


def _bshd_scale(scale, d) -> float:
    """The token-major kernel's logit factor, JAX's ``scale * LOG2E`` (scale
    None means 1/sqrt(D); no prescaled convention), rounded to f32."""
    return float(torch.tensor((1.0 / math.sqrt(d) if scale is None else scale) * LOG2E, dtype=torch.float32))


def bshd_tile(skv: int) -> int:
    """JAX's kv tile of ``flash_attention_bshd``: ``min(1536, round_up(Skv, 128))``."""
    return min(1536, _round_up(skv, 128))


def flash_attention_bshd_plain(q, k, v, *, scale=None, bkv=None):
    """The online recurrence over (B, S, H, D) tensors, rescaling once per
    ``bkv`` kv columns: JAX's tile (:func:`bshd_tile`) by default, the
    kernel's :data:`ONLINE_BKV` to compare with the kernel."""
    bkv = bshd_tile(k.shape[1]) if bkv is None else bkv
    o = _online_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), _bshd_scale(scale, q.shape[-1]),
                      bkv)
    return o.transpose(1, 2)


def flash_attention_bshd(q, k, v, *, scale=None):
    """Dense non-causal attention over token-major tensors: q (B, Sq, H, D),
    k, v (B, Skv, H, D) bf16 -> (B, Sq, H, D) bf16, as they come from the
    fused QKV GEMM by a reshape. Logits ``f32(q . k) * (scale * log2(e))``
    (``scale`` None: 1/sqrt(D)), ``p = exp2(bf16(s - m))`` in bf16, ``o =
    acc / l``; ragged and unequal Sq, Skv. On the card the kernel reads each
    head with a row stride of H*D (head dim 128)."""
    if not q.is_cuda:
        return flash_attention_bshd_plain(q, k, v, scale=scale)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _build.require(d == KERNEL_HEAD_DIM, f"token-major flash kernel is built for head_dim {KERNEL_HEAD_DIM}, got {d}")
    _build.require(all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in (q, k, v)),
                   "token-major flash kernel takes contiguous bf16 q, k, v")
    _build.require(tuple(k.shape) == tuple(v.shape) == (b, skv, h, d) and skv > 0,
                   "k and v must be (B, Skv, H, D) like q, Skv > 0")
    q, k, v = (_aligned16(t) for t in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    _build.check(lib.nt_flash_online_bshd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, skv,
                                          _bshd_scale(scale, d), torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_online_bshd")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pooled_block_scores(q, k, *, bq: int = POOL_SIZE, bkv: int = POOL_SIZE) -> torch.Tensor:
    """(B, H, nq, nk) f32 scores of :func:`select_blocks`: each window of
    ``bq`` query / ``bkv`` key tokens pooled by the f32 mean over its valid
    tokens, the pooled blocks scored by an f32 batched product."""
    b, h, _, d = q.shape

    def pool(t, blk):
        s = t.shape[2]
        n = -(-s // blk)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, n * blk - s)).reshape(b, h, n, blk, d)
        counts = (s - torch.arange(n, device=t.device) * blk).clamp(1, blk).float()
        return t.sum(dim=3) / counts[:, None]

    return pool(q, bq) @ pool(k, bkv).transpose(-1, -2)


def select_blocks(q, k, sparsity_ratio: float, *, bq: int = POOL_SIZE, bkv: int = POOL_SIZE) -> torch.Tensor:
    """Pooled-score top-k block selection (JAX ``select_blocks`` :1204).

    q, k: (B, H, S, D) after norm and RoPE (the FLUX route passes its
    prescaled q, as JAX does). Each query block keeps the top ``kk =
    max(1, int(nk * (1 - sparsity_ratio)))`` kv blocks by
    :func:`pooled_block_scores`, sorted ascending -> int32 (B, H, nq, kk) on
    q's device (no host sync)."""
    nk = -(-k.shape[2] // bkv)
    kk = max(1, int(nk * (1.0 - sparsity_ratio)))
    scores = pooled_block_scores(q, k, bq=bq, bkv=bkv)
    return torch.topk(scores, kk, dim=-1).indices.sort(dim=-1).values.to(torch.int32)


def block_sparse_mask(block_idx, sq: int, skv: int, *, bq: int, bkv: int) -> torch.Tensor:
    """(B, H, nq, kk) block ids -> the (B, H, Sq, Skv) bool mask they select."""
    b, h, nq, _ = block_idx.shape
    allowed = torch.zeros((b, h, nq, -(-skv // bkv)), dtype=torch.bool, device=block_idx.device)
    allowed.scatter_(-1, block_idx.long(), True)
    tok_q = torch.arange(sq, device=block_idx.device) // bq
    tok_k = torch.arange(skv, device=block_idx.device) // bkv
    return allowed[:, :, tok_q][:, :, :, tok_k]


def block_sparse_reference(q, k, v, block_idx, scale=None, *, bq=POOL_SIZE, bkv=POOL_SIZE):
    """Oracle (JAX ``block_sparse_reference`` :1345): dense f32 attention
    restricted to the selected kv blocks, (B, H, Sq, D) in q's dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = block_sparse_mask(block_idx, q.shape[2], k.shape[2], bq=bq, bkv=bkv)
    s = q.float() @ k.float().transpose(-1, -2)
    s = torch.where(mask, s * scale, -math.inf)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _bs_operands(q, k, v, block_idx, bq, bkv):
    """The twins' view of the work: q in query blocks (B*H, nq, bq, D) f32
    (ragged rows zero), and a function giving, for the j-th selected id of
    every (head, query block), that kv block's k and v (B*H, nq, bkv, D) f32
    and its valid columns (B*H, nq, 1, bkv)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    nq, nk = -(-sq // bq), -(-skv // bkv)
    pad = torch.nn.functional.pad
    qb = pad(q, (0, 0, 0, nq * bq - sq)).reshape(b * h, nq, bq, d).float()
    kb = pad(k, (0, 0, 0, nk * bkv - skv)).reshape(b * h, nk, bkv, d)
    vb = pad(v, (0, 0, 0, nk * bkv - skv)).reshape(b * h, nk, bkv, d)
    idx = block_idx.reshape(b * h, nq, -1).long()
    rows = torch.arange(b * h, device=q.device)[:, None]

    def block(j):
        blk = idx[..., j]
        cols = blk[..., None] * bkv + torch.arange(bkv, device=q.device)
        return kb[rows, blk].float(), vb[rows, blk].float(), (cols < skv)[:, :, None, :]

    return qb, block, idx.shape[-1]


def _bs_out(o, q, out_bshd):
    b, h, sq, d = q.shape
    o = o.reshape(b, h, -1, d)[:, :, :sq].to(q.dtype)
    return o.transpose(1, 2).reshape(b, sq, h * d) if out_bshd else o


def block_sparse_fixed_plain(q, k, v, block_idx, *, scale=None, bq, bkv, out_bshd=False):
    """The fixed-shift kernel's arithmetic in torch ops, block by selected
    block: ``s = f32(q . k) * c`` (c from :func:`_logit_scale`), columns past
    Skv -> -1e30, ``p = exp2(min(s, 116) - 16)``, ``out = sum(bf16(p) @ v) /
    sum(p)``."""
    c = _logit_scale(scale, q.shape[-1])
    qb, block, kk = _bs_operands(q, k, v, block_idx, bq, bkv)
    l = torch.zeros(qb.shape[:-1] + (1,), dtype=torch.float32, device=q.device)
    acc = torch.zeros_like(qb)
    for j in range(kk):
        kj, vj, ok = block(j)
        s = torch.where(ok, (qb @ kj.transpose(-1, -2)) * c, NEG_INF)
        p = torch.exp2(torch.clamp(s, max=FIXED_CAP) - FIXED_SHIFT)
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + p.to(torch.bfloat16).float() @ vj
    return _bs_out(acc / l, q, out_bshd)


def block_sparse_online_plain(q, k, v, block_idx, *, scale=None, bq, bkv, out_bshd=False, tile=ONLINE_BKV):
    """The online kernel's recurrence in torch ops over the selected blocks
    in ascending order, rescaling once per ``tile`` columns (the kernel's
    128 by default; the TPU kernel rescales once per block). A tile past Skv
    is all -1e30: it leaves m, l and acc exactly as they were, as the kernel
    that skips it does."""
    c = _logit_scale(scale, q.shape[-1])
    qb, block, kk = _bs_operands(q, k, v, block_idx, bq, bkv)
    m = torch.full(qb.shape[:-1] + (1,), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qb)
    for j in range(kk):
        kj, vj, ok = block(j)
        for c0 in range(0, bkv, tile):
            s = torch.where(ok[..., c0:c0 + tile], (qb @ kj[:, :, c0:c0 + tile].transpose(-1, -2)) * c, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2((s - m_new).to(torch.bfloat16).float()).to(torch.bfloat16).float()
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vj[:, :, c0:c0 + tile]
            m = m_new
    return _bs_out(acc / l, q, out_bshd)


def block_sparse_attention(q, k, v, *, sparsity_ratio: float, scale=None, block_idx=None, bq: int = 768,
                           bkv: int = 1536, out_bshd: bool = False, fixed_softmax: bool = False):
    """Block-sparse non-causal attention over (B, H, S, D) bf16 q, k, v.

    Each query block of ``bq`` tokens attends only to the ``kk`` kv blocks
    of ``bkv`` tokens that :func:`select_blocks` picks for it (or
    ``block_idx``, int32 (B, H, nq, kk), consistent with bq and bkv); the
    softmax normalizes over the selected blocks. ``bq`` and ``bkv`` shrink
    to the sequence rounded up to 128. ``scale`` None means 1/sqrt(D), 1.0
    that q already carries scale * log2(e). ``fixed_softmax`` takes the
    fixed-shift form (count ``bs_fixed``), else the running max
    (``bs_online``). -> (B, Sq, H*D) with ``out_bshd``, else (B, H, Sq, D).
    On the card: the kernels, head dim 128 only."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bq = min(bq, _round_up(sq, BS_TILE))
    bkv = min(bkv, _round_up(skv, BS_TILE))
    if block_idx is None:
        block_idx = select_blocks(q, k, sparsity_ratio, bq=bq, bkv=bkv)
    if not q.is_cuda:
        twin = block_sparse_fixed_plain if fixed_softmax else block_sparse_online_plain
        return twin(q, k, v, block_idx, scale=scale, bq=bq, bkv=bkv, out_bshd=out_bshd)
    nq = -(-sq // bq)
    _build.require(d == KERNEL_HEAD_DIM, f"block-sparse kernels are built for head_dim {KERNEL_HEAD_DIM}, got {d}")
    _build.require(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "block-sparse kernels take bf16 q, k, v")
    _build.require(tuple(k.shape) == tuple(v.shape) == (b, h, skv, d) and skv > 0,
                   "k and v must be (B, H, Skv, D) like q, Skv > 0")
    _build.require(bq % BS_TILE == 0 and bkv % BS_TILE == 0, f"bq and bkv must be multiples of {BS_TILE}")
    _build.require(block_idx.dtype == torch.int32 and block_idx.device == q.device and block_idx.dim() == 4
                   and tuple(block_idx.shape[:3]) == (b, h, nq) and block_idx.shape[3] >= 1,
                   f"block_idx must be int32 (B, H, nq={nq}, kk) on q's device")
    qc, kc, vc, idx = _aligned16(q), _aligned16(k), _aligned16(v), block_idx.contiguous()
    out = torch.empty((b, sq, h * d) if out_bshd else (b, h, sq, d), dtype=torch.bfloat16, device=q.device)
    name = "bs_fixed" if fixed_softmax else "bs_online"
    lib = _build.library()
    fn = lib.nt_bs_fixed if fixed_softmax else lib.nt_bs_online
    _build.check(fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), idx.data_ptr(), out.data_ptr(), b, h, sq, skv,
                    nq, idx.shape[3], bq, bkv, int(out_bshd), _logit_scale(scale, d),
                    torch.cuda.current_stream(q.device).cuda_stream), name)
    BS_COUNTS[name].launches += 1
    return out
