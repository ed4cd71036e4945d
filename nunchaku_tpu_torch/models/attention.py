"""FLUX joint attention and the quantized MLP chain.

Counterparts of ``nunchaku_tpu/models/attention.py``: ``qkv_norm_rope``
(:38); the half-split weight permutation (``permute_qk_halfsplit`` :148);
``FluxAttention`` on its unfused branch (:470-513: fused QKV projection,
q/k RMSNorm and interleaved RoPE as tensor ops) and its fused branch
(``_forward_fused`` :242-368: the qkv/RoPE producer kernel, with the
projections' low-rank terms inside it and the dual block's txt and img
streams in one joint buffer), both ending in flash attention with (B, S,
H*D) output and an optional (B, S_kv) kv mask (Qwen-Image's padded
prompts): fixed-shift, or online on the unfused branch when
``fixed_softmax`` is False (JAX ``_attend`` :371), or, with no kv mask and
``sparsity_ratio > 0`` (``set_attention_impl("blocksparse")``), block-sparse
attention in the same softmax form (the fused prologue then stays off, as in
JAX :424-431); under sequence parallelism (``sp_axis``, set by
``parallel.sp.parallelize_sequence*``) the ring attention over the process
group (the fused prologue stays off too); without a kv mask, ``attn_int8``
takes the int8 q . k form and ``attn_kv_unroll = 2`` the two-tile form of
the fixed-shift kernel (:395-404); and ``FeedForward`` /
``gelu_mlp`` (:527-768): on the int8 / w4a8 chain route fc1's GEMM emits
fc2's int8 activations through the GELU -> requantize epilogue and fc2
consumes their grouped scales (w4a8: on dequantized weights, or on the
packed ones under ``NUNCHAKU_TPU_W4A8_FUSED=1``), optionally fed by the LN +
modulate + quantize producer and ending in the block's gated residual add;
the int4 / nvfp4 linears, and w4a8 ones when neither w4a8 route switch
allows a chain, take the unfused route (fc1, GELU, fc2 through their own
quantize steps).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.attention import (
    KERNEL_HEAD_DIM,
    LOG2E,
    block_sparse_attention,
    flash_attention,
    flash_attention_i8,
    flash_attention_online,
    qkv_rope_producer,
    quantize_qk,
)
from ..ops.gemm import (chain_ptoken, dequant_w4a8, res_apply, svdq_gemm_w4a4, svdq_gemm_w8a8_gelu_quant,
                        w4a8_fused, w4a8_use_xla)
from ..ops.quantize import ln_mod_quant_int8, rsmooth_of
from ..ops.reference import gelu_jax, layer_norm, rmsnorm
from .embeddings import apply_rope
from .linear import SVDQW4A4Linear


def qkv_norm_rope(qkv, head_dim, norm_q, norm_k, rot, prescale):
    """(B, S, 3*H*D) -> q, k, v (B, H, S, D); q/k RMSNorm, RoPE, and
    ``prescale`` folded into q."""
    b, s, _ = qkv.shape
    heads = qkv.shape[-1] // 3 // head_dim
    q, k, v = (t.reshape(b, s, heads, head_dim).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    q = apply_rope(rmsnorm(q, norm_q).to(qkv.dtype), rot, scale=prescale)
    k = apply_rope(rmsnorm(k, norm_k).to(qkv.dtype), rot)
    return q, k, v


def prep_halfsplit(qkv, cos, sin, norm_q, norm_k, heads, head_dim, q_scale):
    """(B, S, 3*H*D) -> q, k, v (B, H, S, D): q/k RMSNorm (eps 1e-6), the
    half-split RoPE of an ``ops.attention.rope_table_halfsplit`` table and
    ``q_scale`` folded into q, as torch ops (JAX ``_prep_halfsplit``,
    attention.py:81, the head dims the producer kernel does not take)."""
    b, s, _ = qkv.shape
    half = head_dim // 2
    q, k, v = (t.reshape(b, s, heads, head_dim).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    c1, s1, c2, s2 = cos[..., :half], sin[..., :half], cos[..., half:], sin[..., half:]

    def norm_rope(t, w, scale):
        tf = t.float()
        tf = tf * torch.rsqrt((tf * tf).mean(dim=-1, keepdim=True) + 1e-6) * w.float()
        a1, a2 = tf[..., :half], tf[..., half:]
        return torch.cat([(a1 * c1 + a2 * s1) * scale, (a2 * c2 + a1 * s2) * scale], dim=-1).to(qkv.dtype)

    return norm_rope(q, norm_q, q_scale), norm_rope(k, norm_k, 1.0), v


def _halfsplit_head_perm(head_dim: int) -> np.ndarray:
    """Channel order that moves the interleaved rope pairs (2i, 2i+1) to
    the half-split pairs (i, i + D/2): new[i] = old[2i], new[i + D/2] =
    old[2i + 1]."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def _halfsplit_qkv_perm(heads: int, head_dim: int, n: int) -> np.ndarray:
    """Output-channel order of a fused [q | k | v] projection: each head of
    the q and k sections in half-split order, v and any padding in place."""
    hd = heads * head_dim
    per_head = (np.arange(heads)[:, None] * head_dim + _halfsplit_head_perm(head_dim)[None]).ravel()
    parts = [per_head, hd + per_head, 2 * hd + np.arange(hd)]
    if n > 3 * hd:
        parts.append(np.arange(3 * hd, n))
    return np.concatenate(parts)


def _permute_out_channels(lin: SVDQW4A4Linear, perm: np.ndarray) -> None:
    """Reorder a quantized linear's output channels: every N-axis buffer
    (a LoRA's unit-strength rows too) moves together, each into a new tensor
    of its layout, so a model that shares its buffers with another (a LoRA'd
    model and its base) leaves the other's unchanged. A layer view of a
    stack would lose its link to the stack: :func:`permute_qk_halfsplit`
    takes the stacked module, or a module of its own."""
    idx = torch.as_tensor(perm, device=lin.qweight.device)
    for name in ("qweight", "wscales", "proj_up", "bias", "rescales", "lora_up_unit"):
        t = getattr(lin, name)
        if t is not None:
            setattr(lin, name, torch.empty_like(t).copy_(t.index_select(-1, idx)))


def permute_qk_halfsplit(attn: "FluxAttention") -> None:
    """Put the q/k output channels of the QKV projections and the q/k
    RMSNorm weights in half-split rope order (new tensors) and switch the
    module to the fused prologue. The attention's result is unchanged: q and
    k move together, v and the output projections stay. ``attn`` is a
    stacked module (every layer moves) or an attention of its own; a model
    rebuilds its layer views afterwards."""
    if attn.prep_fused:
        raise ValueError("the attention weights are already in half-split order")
    if attn.head_dim != KERNEL_HEAD_DIM:
        raise NotImplementedError(f"the fused qkv prologue is ported for head_dim {KERNEL_HEAD_DIM}")
    heads = attn.to_qkv.out_features // 3 // attn.head_dim
    perm = _halfsplit_qkv_perm(heads, attn.head_dim, attn.to_qkv.out_features)
    hperm = torch.as_tensor(_halfsplit_head_perm(attn.head_dim), device=attn.norm_q.device)
    _permute_out_channels(attn.to_qkv, perm)
    if attn.add_qkv_proj is not None:
        _permute_out_channels(attn.add_qkv_proj, perm)
    for name in ["norm_q", "norm_k"] + (["norm_added_q", "norm_added_k"] if attn.add_qkv_proj is not None else []):
        t = getattr(attn, name)
        setattr(attn, name, torch.empty_like(t).copy_(t.index_select(-1, hperm)))
    attn.prep_fused = True


class FluxAttention(nn.Module):
    """Joint txt+img attention with fused quantized QKV projections.

    Dual-stream blocks hold img (to_qkv / to_out) and txt (add_qkv_proj /
    to_add_out) projections and attend over the [txt; img] concat;
    single-stream blocks hold to_qkv only and return the raw attention."""

    def __init__(self, to_qkv, norm_q, norm_k, to_out=None, add_qkv_proj=None,
                 norm_added_q=None, norm_added_k=None, to_add_out=None, *, head_dim):
        super().__init__()
        self.to_qkv = to_qkv
        self.to_out = to_out
        self.add_qkv_proj = add_qkv_proj
        self.to_add_out = to_add_out
        for name, t in (("norm_q", norm_q), ("norm_k", norm_k), ("norm_added_q", norm_added_q),
                        ("norm_added_k", norm_added_k)):
            self.register_buffer(name, t)
        self.head_dim = head_dim
        self.prep_fused = False  # set by permute_qk_halfsplit
        # the fixed-shift softmax; False takes the online kernel on the
        # unfused branch (the fused one always takes the fixed shift, as in JAX)
        self.fixed_softmax = True
        # > 0: block-sparse attention when there is no kv mask (set by
        # FluxTransformer2DModel.set_attention_impl)
        self.sparsity_ratio = 0.0
        # the process group of the ring attention (parallel.sp); None: no
        # sequence parallelism
        self.sp_axis = None
        # int8 q . k with per-token scales (flash_attention_i8) when there is no kv mask
        self.attn_int8 = False
        # 2: the fixed-shift kernel's two-tile form when there is no kv mask
        self.attn_kv_unroll = 1

    @classmethod
    def random_init(cls, gen, dim, heads, head_dim, joint=True, rank=32, precision="w4a8",
                    device="cuda"):
        """Quantized projections of ``precision`` (JAX attention.py:444-468)."""
        inner = heads * head_dim

        def lin(k, n):
            return SVDQW4A4Linear.random_init(gen, k, n, rank=rank, precision=precision, device=device)

        def ones():
            return torch.ones((head_dim,), dtype=torch.bfloat16, device=device)

        if not joint:
            return cls(lin(dim, 3 * inner), ones(), ones(), head_dim=head_dim)
        return cls(lin(dim, 3 * inner), ones(), ones(), to_out=lin(inner, dim),
                   add_qkv_proj=lin(dim, 3 * inner), norm_added_q=ones(), norm_added_k=ones(),
                   to_add_out=lin(inner, dim), head_dim=head_dim)

    def forward(self, hidden, encoder_hidden, rot, mods=None, kv_mask=None):
        """Dual: (img_attn_out, txt_attn_out). Single: raw attention (B, S, H*D).

        ``mods = ((scale, shift), (scale_txt, shift_txt) | None)``: the
        inputs are the RAW bf16 streams and LayerNorm + AdaLN modulation run
        in the projections' quantize producers (``forward_modulated``).
        After :func:`permute_qk_halfsplit`, ``rot`` must be the half-split
        ``(cos, sin)`` pair and the prologue is the qkv/RoPE producer
        kernel; with ``mods`` the qkv GEMMs then skip their low-rank
        epilogue and the producer adds it. A rope table in the other layout
        than the weights' raises. ``kv_mask``: (B, S_txt + S_img) validity of
        the joint keys (bool, True = attend), passed to flash. Block-sparse
        attention (``sparsity_ratio > 0``) and sequence parallelism
        (``sp_axis``) run on the unfused branch only: after
        :func:`permute_qk_halfsplit` they raise, as in JAX."""
        if self.prep_fused and self.sparsity_ratio == 0.0 and self.sp_axis is None:
            if not isinstance(rot, tuple):
                raise ValueError("the q/k weights are in half-split order (permute_qk_halfsplit): "
                                 "rot must be the (cos, sin) pair of rope_table_halfsplit")
            if mods is None:
                qkv, lora_img = self.to_qkv(hidden), None
            else:
                qkv, la = self.to_qkv.forward_modulated(hidden, *mods[0], skip_lora=True)
                lora_img = (la, self.to_qkv.proj_up)
            return self._forward_fused(qkv, encoder_hidden, rot, lora_img,
                                       None if mods is None else mods[1], kv_mask)
        if isinstance(rot, tuple):
            raise ValueError("the half-split (cos, sin) rope table needs the fused prologue "
                             "(permute_qk_halfsplit), which runs with dense attention only and "
                             "without sequence parallelism")
        qkv = self.to_qkv(hidden) if mods is None else self.to_qkv.forward_modulated(hidden, *mods[0])
        prescale = LOG2E / math.sqrt(self.head_dim)
        if encoder_hidden is None:
            q, k, v = qkv_norm_rope(qkv, self.head_dim, self.norm_q, self.norm_k, rot, prescale)
            return self._attend(q, k, v, kv_mask)
        s_txt = encoder_hidden.shape[1]
        if mods is not None and mods[1] is not None:
            qkv_txt = self.add_qkv_proj.forward_modulated(encoder_hidden, *mods[1])
        else:
            qkv_txt = self.add_qkv_proj(encoder_hidden)
        q_i, k_i, v_i = qkv_norm_rope(qkv, self.head_dim, self.norm_q, self.norm_k, rot[s_txt:],
                                      prescale)
        q_t, k_t, v_t = qkv_norm_rope(qkv_txt, self.head_dim, self.norm_added_q,
                                      self.norm_added_k, rot[:s_txt], prescale)
        o = self._attend(torch.cat([q_t, q_i], dim=2), torch.cat([k_t, k_i], dim=2),
                         torch.cat([v_t, v_i], dim=2), kv_mask)
        txt_o, img_o = o[:, :s_txt], o[:, s_txt:]
        return self.to_out(img_o), self.to_add_out(txt_o)

    def _attend(self, q, k, v, kv_mask):
        """Prescaled q -> (B, S, H*D), in JAX's order (:370-404): the ring
        attention over ``sp_axis`` under sequence parallelism (no kv mask:
        it raises); block-sparse attention when there is no kv mask and
        ``sparsity_ratio > 0``; the int8 form under ``attn_int8`` and no kv
        mask; else flash, the fixed-shift form (two-tile at
        ``attn_kv_unroll = 2`` without a kv mask) or the online one when
        ``fixed_softmax`` is False."""
        if self.sp_axis is not None:
            from ..parallel.sp import ring_attention

            if kv_mask is not None:  # the JAX ring drops a mask silently; the port refuses it
                raise ValueError("sequence parallelism takes no kv mask: the ring attention has no masked form")
            o = ring_attention(q, k, v, self.sp_axis, scale=1.0)
            b, h, s, d = o.shape
            return o.transpose(1, 2).reshape(b, s, h * d)
        if kv_mask is None and self.sparsity_ratio > 0.0:
            return block_sparse_attention(q, k, v, sparsity_ratio=self.sparsity_ratio, scale=1.0, out_bshd=True,
                                          fixed_softmax=self.fixed_softmax)
        if kv_mask is None and self.attn_int8:
            q8, qs, k8, ks = quantize_qk(q, k)
            return flash_attention_i8(q8, qs, k8, ks, v, out_bshd=True)
        if self.fixed_softmax:
            return flash_attention(q, k, v, kv_mask, kv_unroll=self.attn_kv_unroll)
        return flash_attention_online(q, k, v, scale=1.0, kv_mask=kv_mask, out_bshd=True)

    def _forward_fused(self, qkv, encoder_hidden, rot, lora_img, mods_txt, kv_mask):
        cos, sin = rot
        kw = dict(q_scale=LOG2E / math.sqrt(self.head_dim))

        def lora(pair):
            return {} if pair is None else dict(lora_act=pair[0], proj_up=pair[1])

        if encoder_hidden is None:
            q, k, v = qkv_rope_producer(qkv, cos, sin, self.norm_q, self.norm_k, **kw, **lora(lora_img))
            return flash_attention(q, k, v, kv_mask)
        b, s_img, _ = qkv.shape
        s_txt = encoder_hidden.shape[1]
        if mods_txt is not None:
            qkv_txt, la = self.add_qkv_proj.forward_modulated(encoder_hidden, *mods_txt, skip_lora=True)
            lora_txt = (la, self.add_qkv_proj.proj_up)
        else:
            qkv_txt, lora_txt = self.add_qkv_proj(encoder_hidden), None
        # both streams write one (B, H, S_txt + S_img, D) buffer set: img
        # rows after the txt rows, no concatenation
        heads = qkv.shape[-1] // 3 // self.head_dim
        joint = tuple(torch.empty((b, heads, s_txt + s_img, self.head_dim), dtype=torch.bfloat16,
                                  device=qkv.device) for _ in range(3))
        qkv_rope_producer(qkv, cos[s_txt:], sin[s_txt:], self.norm_q, self.norm_k, out=joint,
                          s_offset=s_txt, **kw, **lora(lora_img))
        q, k, v = qkv_rope_producer(qkv_txt, cos[:s_txt], sin[:s_txt], self.norm_added_q,
                                    self.norm_added_k, out=joint, s_offset=0, **kw, **lora(lora_txt))
        o = flash_attention(q, k, v, kv_mask)
        txt_o, img_o = o[:, :s_txt], o[:, s_txt:]
        return self.to_out(img_o), self.to_add_out(txt_o)


def can_chain(fc1: SVDQW4A4Linear, fc2: SVDQW4A4Linear) -> bool:
    """Whether the pair takes the requantize chain (JAX ``_can_chain``,
    attention.py:567-582): matching int8 linears, or matching w4a8 ones
    while either route switch serves a chain (:func:`w4a8_fused` or
    :func:`w4a8_use_xla`; with ``NUNCHAKU_TPU_W4A8_XLA=0`` and the fused
    route off, fc1, GELU and fc2 run apart, each a packed GEMM)."""
    p = fc1.precision
    return fc2.precision == p and (p == "int8" or (p == "w4a8" and (w4a8_fused() or w4a8_use_xla())))


def gelu_mlp(fc1: SVDQW4A4Linear, fc2: SVDQW4A4Linear, x: torch.Tensor, mod=None,
             residual=None, stacked=None) -> torch.Tensor:
    """fc1 -> GELU -> fc2.

    int8 / w4a8 (:func:`can_chain`): fc1's GEMM emits fc2's int8
    activations with one scale per (token, bn-column group), shifted first
    when fc2 takes unsigned activations (a model from an int4 checkpoint),
    and fc2's GEMM consumes them group by group. w4a8 weights are
    dequantized to int8 for the int8 chain kernels (fc1, then fc2; int4 or
    e2m1 codes), or, under :func:`w4a8_fused` with int4 codes, read packed
    by the W4 producer and the packed grouped consumer (JAX :674-705).
    Otherwise (int4, nvfp4, and w4a8 with both route switches against a
    chain) fc1, the f32 GELU of ``jax.nn.gelu(approximate=True)`` and fc2
    run apart (fc2's quantize adds the post-GELU shift of an unsigned fc2).

    ``mod = (scale, shift)``: x is the RAW bf16 stream (B, S, K) and LN +
    modulate come first (on the chain, the LN + modulate + quantize
    producer makes fc1's activations). ``residual = (x_stream, gate[, extra[,
    extra_lora_act, extra_proj_up]])`` (all (B, S, ·), gate (B, N)) returns
    ``x_stream + gate * (mlp_out [+ extra + extra_lora])``, on the chain
    fused into the grouped consumer's epilogue.

    ``stacked = (fc1_qweight_stack, fc2_qweight_stack, layer_idx)`` (JAX
    :602-606): fc1 and fc2 are a layer's views and the chain kernels read
    that layer of the whole stacks by its 0-d int32 index on the card: the
    int8 chain's stacked producer and consumer, the stacked dequant of both
    stacks on the w4a8 dequant route (the int8 chain then runs on the
    dequantized layer, as JAX :712-735), the packed pair's stacked modes
    under :func:`w4a8_fused`. With ``NUNCHAKU_TPU_CHAIN_PTOKEN=1``
    (:func:`~nunchaku_tpu_torch.ops.gemm.chain_ptoken`, read at each call;
    int8 only) the producer emits one scale per token and fc2 is a rank-1
    int8 product: the consumer kernel's stacked rank-1 mode, or, without
    ``stacked``, ``torch._int_mm`` (JAX's XLA dot)."""
    if not can_chain(fc1, fc2):
        if mod is not None:
            x = (layer_norm(x) * (1.0 + mod[0].float()[:, None]) + mod[1].float()[:, None]).to(torch.bfloat16)
        out = fc2(gelu_jax(fc1(x)).to(torch.bfloat16))
        return out if residual is None else res_apply(out, *residual)
    lead = x.shape[:-1]
    m = math.prod(lead)
    if mod is not None:
        qact, asc, la = ln_mod_quant_int8(x.to(torch.bfloat16), mod[0], mod[1], fc1.smooth, fc1.proj_down)
        pad = (-m) % 128  # the chain kernels take 128-row tiles; the producer does not pad
        if pad:
            qact = nn.functional.pad(qact, (0, 0, 0, pad))
            asc = nn.functional.pad(asc, (0, pad))
            la = nn.functional.pad(la, (0, 0, 0, pad))
    else:
        qact, asc, la = fc1.quantize(x.reshape(m, x.shape[-1]))
    w1, w2, idx = (fc1.qweight, fc2.qweight, None) if stacked is None else stacked
    precision, ptoken = "int8", False
    if fc1.precision == "w4a8" and w4a8_fused() and fc1.wcodes != "e2m1":
        precision = "w4a8"  # the packed chain: both kernels decode the int4 weights themselves
    elif fc1.precision == "w4a8":
        w1 = dequant_w4a8(w1, fc1.rescales, fc1.wcodes, idx)
        w2 = dequant_w4a8(w2, fc2.rescales, fc2.wcodes, idx)
        idx = None  # the int8 chain runs on the dequantized layer
    else:
        ptoken = chain_ptoken()
    qout, qs, la2 = svdq_gemm_w8a8_gelu_quant(
        qact, asc, w1, fc1.wscales, la, fc1.proj_up, fc1.bias, rsmooth_of(fc2.smooth),
        fc2.proj_down, act_unsigned_next=fc2.act_unsigned, rescales=fc1.rescales, precision=precision,
        layer_idx=idx, ptoken=ptoken)
    res = None
    if residual is not None and qout.shape[0] == m:
        xr, gate, extra, ela, epu = tuple(residual) + (None,) * (5 - len(residual))

        def flat(t):
            return None if t is None else t.reshape(m, t.shape[-1])

        res = (flat(xr), gate, flat(extra), flat(ela), epu)
    out = svdq_gemm_w4a4(qout, qs, w2, fc2.wscales, la2, fc2.proj_up, fc2.bias, fc2.rescales,
                         precision=precision, residual=res, layer_idx=idx)
    out = out[:m].reshape(*lead, out.shape[-1])
    if residual is not None and res is None:  # padded rows: the add follows the slice
        out = res_apply(out, *residual)
    return out


class FeedForward(nn.Module):
    """fc1 -> GELU(tanh) -> fc2; at int4, fc2 takes unsigned activations
    (the shifted GELU output)."""

    def __init__(self, fc1: SVDQW4A4Linear, fc2: SVDQW4A4Linear):
        super().__init__()
        self.fc1 = fc1
        self.fc2 = fc2

    @classmethod
    def random_init(cls, gen, dim, rank=32, precision="w4a8", device="cuda"):
        hidden = 4 * dim
        return cls(
            SVDQW4A4Linear.random_init(gen, dim, hidden, rank=rank, precision=precision, device=device),
            SVDQW4A4Linear.random_init(gen, hidden, dim, rank=rank, precision=precision,
                                       act_unsigned=precision == "int4", device=device),
        )

    def forward(self, x, mod=None, residual=None, stacked=None):
        return gelu_mlp(self.fc1, self.fc2, x, mod=mod, residual=residual, stacked=stacked)
