"""Z-Image (S3-DiT) transformer with SVDQuant linears, through stacked layers.

Counterpart of ``nunchaku_tpu/models/transformers/transformer_zimage.py``:
``ZImageConfig`` (:46), ``ZImageAttention`` (:75: fused QKV, q/k RMSNorm and
RoPE, the fixed-shift flash kernel with (B, S, H*D) output),
``ZImageFeedForward`` (:146: SwiGLU ``w2(silu(gate) * value)`` with the GLU
fused into w2's activation quantize, or unfused on plain ``Linear``
refiners), ``ZImageTransformerBlock`` (:191: sandwich RMSNorms, tanh-gated
4-way adaLN, or unmodulated in the context refiner) and
``ZImageTransformer2DModel`` (:248).

Each of the three stacks (``noise_refiner``, ``context_refiner``, ``layers``)
is one module whose buffers carry a leading layer axis, the JAX layout: its
parameter names and shapes are the JAX model's. The JAX ``_scan`` (:322-336)
becomes a loop over per-layer view modules (:func:`~.linear.slice_module`,
no copies), built once and rebuilt only when the stacks move or change
order; at w4a8, int4 and nvfp4 each view's linears are attached to the
whole qweight stack and a device-resident layer index
(:func:`~.linear.attach_stacked_weights`), so their GEMM kernels read the
layer by index on the card (the stacked modes of ``ops/gemm.py``), as the
Pallas kernels do by scalar prefetch. int8 stacks (an nvfp4 file loaded at
w4a8 becomes int8, as in JAX) and unquantized refiners take the layer's own
weights.

Under sequence parallelism (``parallel.sp.parallelize_sequence_zimage``) each
stage's attention is the ring over its local tokens.

Attention prologues: the interleaved-pair q/k RMSNorm + RoPE as torch ops by
default, or after :meth:`ZImageTransformer2DModel.enable_fused_qkv_prep`
(which permutes the to_qkv, norm_q and norm_k stacks in place) the half-split
form: the qkv/RoPE producer kernel at head dim 128 (no low-rank operands:
the projection's own epilogue adds them, so any rank runs it), torch ops
(:func:`~.attention.prep_halfsplit`) at other head dims. q and k RMSNorm take
eps 1e-6 on both routes (the JAX defaults), the blocks' norms ``norm_eps``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import KERNEL_HEAD_DIM, LOG2E, flash_attention, qkv_rope_producer, rope_table_halfsplit
from ..ops.quantize import glu_product, quantize_w4a4_act_fuse_lora
from ..ops.reference import rmsnorm
from .attention import (_halfsplit_head_perm, _halfsplit_qkv_perm, prep_halfsplit, qkv_norm_rope)
from .embeddings import rope_table, timestep_embedding
from .linear import PAD_TOKENS, Linear, StackedLayers, SVDQW4A4Linear, build_stacked, pad_rows

BF16 = torch.bfloat16
STACKS = ("noise_refiner", "context_refiner", "layers")


@dataclass(frozen=True)
class ZImageConfig:
    """The JAX config's fields and defaults (placeholders: a loader reads the
    file's ``config`` metadata)."""

    dim: int = 1024
    num_layers: int = 4
    num_refiner_layers: int = 2
    num_attention_heads: int = 8
    in_channels: int = 16
    patch_size: int = 2
    cap_feat_dim: int = 1024
    norm_eps: float = 1e-5
    axes_dims_rope: tuple = (32, 48, 48)
    rank: int = 32
    precision: str = "int4"
    ffn_inner: int | None = None  # default 8/3 * dim rounded up to 256

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_attention_heads

    @property
    def inner_ffn(self) -> int:
        if self.ffn_inner is not None:
            return self.ffn_inner
        return ((int(self.dim * 8 / 3) + 255) // 256) * 256

    @property
    def t_dim(self) -> int:
        return min(self.dim, 1024)


def _svdq(gen, k, n, cfg, device):
    return SVDQW4A4Linear.random_init(gen, k, n, rank=cfg.rank, precision=cfg.precision, device=device)


class ZImageAttention(nn.Module):
    def __init__(self, to_qkv, norm_q, norm_k, to_out, *, heads, head_dim):
        super().__init__()
        self.to_qkv = to_qkv  # SVDQW4A4Linear, or Linear in an unquantized refiner
        self.register_buffer("norm_q", norm_q)
        self.register_buffer("norm_k", norm_k)
        self.to_out = to_out
        self.heads = heads
        self.head_dim = head_dim
        # the process group of the ring attention (parallel.sp); None: no sequence parallelism
        self.sp_axis = None

    @classmethod
    def random_init(cls, gen, cfg: ZImageConfig, device="cuda"):
        dim, hd = cfg.dim, cfg.head_dim
        ones = torch.ones((hd,), dtype=BF16, device=device)
        return cls(_svdq(gen, dim, 3 * dim, cfg, device), ones, ones.clone(), _svdq(gen, dim, dim, cfg, device),
                   heads=cfg.num_attention_heads, head_dim=hd)

    def forward(self, x, rot):
        """x (B, S, dim) bf16; ``rot`` the interleaved (S, D/2, 2) table, or
        the half-split (cos, sin) pair after the fused prep -> (B, S, dim).
        Under sequence parallelism (``sp_axis``) the ring attention over the
        group follows either prologue (JAX :129-135)."""
        qkv = self.to_qkv(x)
        heads = qkv.shape[-1] // 3 // self.head_dim
        prescale = LOG2E / math.sqrt(self.head_dim)
        if isinstance(rot, tuple):
            cos, sin = rot
            if self.head_dim == KERNEL_HEAD_DIM:
                q, k, v = qkv_rope_producer(qkv, cos, sin, self.norm_q, self.norm_k, q_scale=prescale)
            else:
                q, k, v = prep_halfsplit(qkv, cos, sin, self.norm_q, self.norm_k, heads, self.head_dim, prescale)
        else:
            q, k, v = qkv_norm_rope(qkv, self.head_dim, self.norm_q, self.norm_k, rot, prescale)
        if self.sp_axis is not None:
            from ..parallel.sp import ring_attention

            b, _, s, _ = q.shape
            return self.to_out(ring_attention(q, k, v, self.sp_axis, scale=1.0).transpose(1, 2).reshape(b, s, -1))
        return self.to_out(flash_attention(q, k, v))


class ZImageFeedForward(nn.Module):
    """SwiGLU ``w2(value * silu(gate))`` over w13's [value | gate] halves."""

    def __init__(self, w13, w2):
        super().__init__()
        self.w13 = w13
        self.w2 = w2

    @classmethod
    def random_init(cls, gen, cfg: ZImageConfig, device="cuda"):
        return cls(_svdq(gen, cfg.dim, 2 * cfg.inner_ffn, cfg, device), _svdq(gen, cfg.inner_ffn, cfg.dim, cfg, device))

    def forward(self, x):
        h = self.w13(x)
        if not isinstance(self.w2, SVDQW4A4Linear):
            return self.w2(glu_product(h))  # a plain-Linear refiner: the unfused SwiGLU
        lead = h.shape[:-1]
        m = math.prod(lead)
        h2 = pad_rows(h.reshape(m, h.shape[-1]), 8 if m <= 8 else PAD_TOKENS)
        q, a, la = quantize_w4a4_act_fuse_lora(h2, self.w2.proj_down, self.w2.smooth, precision=self.w2.precision,
                                               fuse_glu=True)
        out = self.w2.forward_quant(q, a, la)
        return out[:m, :self.w2.logical_out].reshape(*lead, self.w2.logical_out)


class ZImageTransformerBlock(nn.Module):
    """x += tanh(g_msa) * norm2(attn(norm1(x) * (1 + s_msa)));
    x += tanh(g_mlp) * ffn_norm2(ff(ffn_norm1(x) * (1 + s_mlp))); without
    ``adaln`` (the context refiner) no scales or gates."""

    def __init__(self, attention, feed_forward, attention_norm1, attention_norm2, ffn_norm1, ffn_norm2,
                 adaln=None, *, eps=1e-5):
        super().__init__()
        self.attention = attention
        self.feed_forward = feed_forward
        for name, t in (("attention_norm1", attention_norm1), ("attention_norm2", attention_norm2),
                        ("ffn_norm1", ffn_norm1), ("ffn_norm2", ffn_norm2)):
            self.register_buffer(name, t)
        self.adaln = adaln  # Linear(t_dim, 4 * dim) or None
        self.eps = eps

    @classmethod
    def random_init(cls, gen, cfg: ZImageConfig, modulation=True, device="cuda"):
        ones = [torch.ones((cfg.dim,), dtype=BF16, device=device) for _ in range(4)]
        return cls(ZImageAttention.random_init(gen, cfg, device), ZImageFeedForward.random_init(gen, cfg, device),
                   *ones, Linear.random_init(gen, cfg.t_dim, 4 * cfg.dim, device=device) if modulation else None,
                   eps=cfg.norm_eps)

    def _rms(self, x, w):
        return rmsnorm(x, w, self.eps).to(BF16)

    def forward(self, x, temb, rot):
        """x (B, S, dim) f32 stream, temb (B, t_dim) bf16 or None."""
        if self.adaln is not None:
            mod = self.adaln(F.silu(temb.float()).to(BF16))
            s_msa, g_msa, s_mlp, g_mlp = mod.float().chunk(4, dim=-1)
            h = (self._rms(x.to(BF16), self.attention_norm1).float() * (1.0 + s_msa[:, None])).to(BF16)
            a = self.attention(h, rot)
            x = x + torch.tanh(g_msa)[:, None] * self._rms(a, self.attention_norm2).float()
            h = (self._rms(x.to(BF16), self.ffn_norm1).float() * (1.0 + s_mlp[:, None])).to(BF16)
            f = self.feed_forward(h)
            return x + torch.tanh(g_mlp)[:, None] * self._rms(f, self.ffn_norm2).float()
        a = self.attention(self._rms(x.to(BF16), self.attention_norm1), rot)
        x = x + self._rms(a, self.attention_norm2).float()
        f = self.feed_forward(self._rms(x.to(BF16), self.ffn_norm1))
        return x + self._rms(f, self.ffn_norm2).float()


class ZImageTransformer2DModel(StackedLayers, nn.Module):
    """x / caption embedders, the noise refiner (modulated, image tokens),
    the context refiner (unmodulated, caption tokens), the main layers over
    the joint [caption; image] stream, and the modulated final layer."""

    STACKS = STACKS

    def __init__(self, cfg, x_embedder, t_embedder1, t_embedder2, cap_norm, cap_embedder, noise_refiner,
                 context_refiner, layers, norm_out, proj_out, adaln_out):
        super().__init__()
        self.cfg = cfg
        self.x_embedder = x_embedder
        self.t_embedder1 = t_embedder1
        self.t_embedder2 = t_embedder2
        self.register_buffer("cap_norm", cap_norm)
        self.cap_embedder = cap_embedder
        self.noise_refiner = noise_refiner  # stacked ZImageTransformerBlock, modulated
        self.context_refiner = context_refiner  # stacked, unmodulated
        self.layers = layers  # stacked, modulated
        self.register_buffer("norm_out", norm_out)
        self.proj_out = proj_out
        self.adaln_out = adaln_out  # Linear(t_dim, dim): the final scale
        self._rope_halfsplit = False

    @classmethod
    def random_init(cls, cfg: ZImageConfig, seed: int = 0, device="cuda"):
        """Random weights with the distributions of the JAX ``random_init``
        (not its bits), made on ``device`` from ``seed``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        dim, patch_dim = cfg.dim, cfg.in_channels * cfg.patch_size ** 2

        def stack(n, modulation):
            return build_stacked(lambda i: ZImageTransformerBlock.random_init(gen, cfg, modulation, device), n)

        noise_ref = stack(cfg.num_refiner_layers, True)
        ctx_ref = stack(cfg.num_refiner_layers, False)
        layers = stack(cfg.num_layers, True)
        lin = lambda k, n: Linear.random_init(gen, k, n, device=device)
        return cls(cfg, lin(patch_dim, dim), lin(256, cfg.t_dim), lin(cfg.t_dim, cfg.t_dim),
                   torch.ones((cfg.cap_feat_dim,), dtype=BF16, device=device), lin(cfg.cap_feat_dim, dim),
                   noise_ref, ctx_ref, layers, torch.ones((dim,), dtype=BF16, device=device), lin(dim, patch_dim),
                   lin(cfg.t_dim, dim))

    # -- stacked layers -----------------------------------------------------

    @torch.no_grad()
    def enable_fused_qkv_prep(self, producer: bool = True):
        """The fused attention prologue (JAX :297-320): the q and k output
        channels of every to_qkv stack and the norm_q / norm_k stacks move to
        half-split RoPE order in place, and the forward converts its rope
        tables to half-split (cos, sin) pairs once. The layer views share
        the stacks' storage, so they see the new order."""
        if not producer:
            raise ValueError("Z-Image has no XLA half-split path; producer must be True")
        if self._rope_halfsplit:
            raise ValueError("the attention weights are already in half-split order")
        for name in STACKS:
            attn = getattr(self, name).attention
            if not isinstance(attn.to_qkv, SVDQW4A4Linear):
                raise NotImplementedError("the fused prep permutes quantized to_qkv stacks (a file with "
                                          "skip_refiners keeps plain ones)")
            qkv = attn.to_qkv
            perm = torch.as_tensor(_halfsplit_qkv_perm(attn.heads, attn.head_dim, qkv.out_features),
                                   device=qkv.qweight.device)
            for buf in ("qweight", "wscales", "proj_up", "bias", "rescales"):
                t = getattr(qkv, buf)
                if t is not None:
                    t.copy_(t.index_select(-1, perm))
            hperm = torch.as_tensor(_halfsplit_head_perm(attn.head_dim), device=attn.norm_q.device)
            for buf in (attn.norm_q, attn.norm_k):
                buf.copy_(buf.index_select(-1, hperm))
        self._rope_halfsplit = True
        return self

    def _scan(self, name, x, temb, rot):
        for block in self.layer_views()[name]:
            x = block(x, temb, rot)
        return x

    # -- forward ------------------------------------------------------------

    def forward(self, hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids):
        """hidden_states (B, S_img, in_channels * p^2) patchified tokens,
        encoder_hidden_states (B, S_txt, cap_feat_dim), timestep (B,) in
        [0, 1], img_ids (S_img, 3) / txt_ids (S_txt, 3) rope positions ->
        (B, S_img, in_channels * p^2) bf16."""
        cfg = self.cfg
        t1 = self.t_embedder1(timestep_embedding(timestep * 1000.0, 256))
        temb = self.t_embedder2(F.silu(t1.float()).to(BF16)).to(BF16)
        img = self.x_embedder(hidden_states).float()
        cap = rmsnorm(encoder_hidden_states, self.cap_norm, cfg.norm_eps)
        cap = self.cap_embedder(cap.to(BF16)).float()

        rot_img = rope_table(img_ids.to(img.device), cfg.axes_dims_rope)
        rot_txt = rope_table(txt_ids.to(img.device), cfg.axes_dims_rope)
        rot = torch.cat([rot_txt, rot_img], dim=0)
        if self._rope_halfsplit:
            rot_img, rot_txt, rot = (rope_table_halfsplit(r) for r in (rot_img, rot_txt, rot))

        img = self._scan("noise_refiner", img, temb, rot_img)
        cap = self._scan("context_refiner", cap, None, rot_txt)
        s_txt = cap.shape[1]
        x = self._scan("layers", torch.cat([cap, img], dim=1), temb, rot)

        img = x[:, s_txt:]
        scale = self.adaln_out(F.silu(temb.float()).to(BF16))
        out = rmsnorm(img.to(BF16), self.norm_out, cfg.norm_eps) * (1.0 + scale.float()[:, None])
        return self.proj_out(out.to(BF16))
