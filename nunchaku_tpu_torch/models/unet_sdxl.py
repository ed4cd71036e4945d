"""SDXL UNet with SVDQuant transformer blocks.

Counterpart of ``nunchaku_tpu/models/unets/unet_sdxl.py``: ``Conv2d`` (the
VAE's, :mod:`.autoencoder`), ``GroupNorm``, ``LayerNorm`` and
``ShiftedConv2d`` (:37-137); the quantized ``SDXLAttention`` (:143-191: a
fused SVDQ qkv for self-attention; an SVDQ ``to_q`` with bf16 ``to_k`` /
``to_v`` over the text context for cross-attention; the online flash kernel
at head dim 64, softmax scale 1/sqrt(64)), ``SDXLFeedForward`` (:194-222:
the GEGLU product fused into the second projection's activation quantize),
``SDXLTransformerBlock``, ``SpatialTransformer``, ``ResnetBlock2D``,
``Downsample`` and ``Upsample`` (:225-347), ``SDXLConfig`` and
``SDXLUNet2DConditionModel`` (:358-514).

Layout. The JAX package runs NHWC with HWIO weights; the port keeps
PyTorch's NCHW with OIHW weights (the converter transposes). A spatial
transformer flattens its tokens in the JAX (h, w) row-major order. The
convolutions are ``F.conv2d`` on bf16 operands (JAX leaves them to XLA);
GroupNorm (eps 1e-5) and LayerNorm (eps 1e-5) run in f32 and return the
input's dtype. The stream is bf16 throughout, as in JAX; the forward takes
and returns NCHW (the diffusers contract).

Parameters keep the JAX names (``down_resnets.{level}.{i}``,
``down_attns.{level}.{i}`` with None where a level has no transformer,
``downsamplers.{level}``, ``mid_resnets``, ``mid_attn``, ``up_*``,
``time_lin1/2``, ``add_lin1/2``, ``norm_out``, ``conv_in`` / ``conv_out``),
so ``convert.sdxl_from_jax_params`` maps them one to one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention_online
from ..ops.quantize import quantize_w4a4_act_fuse_lora
from .autoencoder import Conv2d, group_norm
from .embeddings import timestep_embedding
from .linear import PAD_TOKENS, Linear, SVDQW4A4Linear, pad_rows

GN_GROUPS, GN_EPS = 32, 1e-5
LN_EPS = 1e-5
BF16 = torch.bfloat16


def _silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """silu in f32, rounded once to bf16 (JAX ``silu(x.astype(f32)).astype(bf16)``)."""
    return F.silu(x.float()).to(BF16)


class GroupNorm(nn.Module):
    """32-group GroupNorm with f32 statistics and affine, output in x's dtype."""

    def __init__(self, gamma, beta):
        super().__init__()
        self.register_buffer("gamma", gamma)
        self.register_buffer("beta", beta)

    @classmethod
    def random_init(cls, c, device="cuda"):
        return cls(torch.ones((c,), dtype=BF16, device=device), torch.zeros((c,), dtype=BF16, device=device))

    def forward(self, x):
        return group_norm(x, self.gamma, self.beta, GN_GROUPS, GN_EPS)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with affine, f32, eps 1e-5, output in x's dtype."""

    def __init__(self, gamma, beta):
        super().__init__()
        self.register_buffer("gamma", gamma)
        self.register_buffer("beta", beta)

    @classmethod
    def random_init(cls, d, device="cuda"):
        return cls(torch.ones((d,), dtype=BF16, device=device), torch.zeros((d,), dtype=BF16, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.gamma.float(), self.beta.float(), LN_EPS).to(x.dtype)


class ShiftedConv2d(nn.Module):
    """Quantization-aware convolution (deepcompressor ShiftedConv2d): a
    scalar shift is added to the input, and the padding ring holds the
    shift instead of zero (JAX :69-91). The UNet does not use it; it serves
    checkpoints that carry one."""

    def __init__(self, conv: Conv2d, shift: torch.Tensor):
        super().__init__()
        self.conv = conv
        self.register_buffer("shift", shift)

    def forward(self, x):
        pad = self.conv.weight.shape[-1] // 2
        shift = self.shift.float()
        w, b, stride = self.conv.weight, self.conv.bias, self.conv.stride
        if pad and self.conv.padding == pad:
            x = F.pad(x.float(), (pad, pad, pad, pad)) + shift
            return F.conv2d(x.to(BF16), w.to(BF16), None if b is None else b.to(BF16), stride=stride)
        return F.conv2d((x.float() + shift).to(BF16), w.to(BF16), None if b is None else b.to(BF16),
                        stride=stride, padding=self.conv.padding)


# ---------------------------------------------------------------------------
# quantized transformer block
# ---------------------------------------------------------------------------


class SDXLAttention(nn.Module):
    """Self-attention: fused SVDQ qkv. Cross-attention: SVDQ ``to_q``, bf16
    ``to_k`` / ``to_v`` over the context. The online flash kernel at head
    dim 64 writes (B, S, H*D) for ``to_out``."""

    def __init__(self, to_qkv=None, to_q=None, to_k=None, to_v=None, to_out=None, *, head_dim):
        super().__init__()
        self.to_qkv, self.to_q, self.to_k, self.to_v, self.to_out = to_qkv, to_q, to_k, to_v, to_out
        self.head_dim = head_dim

    @classmethod
    def random_init(cls, gen, dim, heads, cross_dim=None, rank=32, precision="int4", device="cuda"):
        svdq = lambda k, n: SVDQW4A4Linear.random_init(gen, k, n, rank=rank, precision=precision, device=device)
        if cross_dim is None:
            return cls(to_qkv=svdq(dim, 3 * dim), to_out=svdq(dim, dim), head_dim=dim // heads)
        return cls(to_q=svdq(dim, dim), to_k=Linear.random_init(gen, cross_dim, dim, device=device),
                   to_v=Linear.random_init(gen, cross_dim, dim, device=device), to_out=svdq(dim, dim),
                   head_dim=dim // heads)

    def forward(self, x, context=None):
        b, s, _ = x.shape
        hd = self.head_dim

        def heads_first(t):
            return t.reshape(b, t.shape[1], -1, hd).transpose(1, 2).to(BF16)

        if context is None:
            q, k, v = (heads_first(t) for t in self.to_qkv(x).chunk(3, dim=-1))
        else:
            q, k, v = heads_first(self.to_q(x)), heads_first(self.to_k(context)), heads_first(self.to_v(context))
        return self.to_out(flash_attention_online(q, k, v, out_bshd=True))


class SDXLFeedForward(nn.Module):
    """GEGLU: ``proj`` (d -> 2 * inner), then ``value * gelu_tanh(gate)``
    computed inside ``out``'s activation quantize, then ``out`` (inner -> d)
    on the quantized activations."""

    def __init__(self, proj: SVDQW4A4Linear, out: SVDQW4A4Linear):
        super().__init__()
        self.proj = proj
        self.out = out

    @classmethod
    def random_init(cls, gen, dim, rank=32, precision="int4", device="cuda"):
        inner = dim * 4
        return cls(SVDQW4A4Linear.random_init(gen, dim, 2 * inner, rank=rank, precision=precision, device=device),
                   SVDQW4A4Linear.random_init(gen, inner, dim, rank=rank, precision=precision, device=device))

    def forward(self, x):
        h = self.proj(x)
        lead = h.shape[:-1]
        m = math.prod(lead)
        h2 = pad_rows(h.reshape(m, h.shape[-1]), 8 if m <= 8 else PAD_TOKENS)
        q, a, la = quantize_w4a4_act_fuse_lora(h2, self.out.proj_down, self.out.smooth,
                                               precision=self.out.precision, fuse_glu=True, glu_act="gelu")
        out = self.out.forward_quant(q, a, la)
        return out[:m, :self.out.logical_out].reshape(*lead, self.out.logical_out)


class SDXLTransformerBlock(nn.Module):
    """LN -> self-attention -> LN -> cross-attention -> LN -> GEGLU FF, each residual."""

    def __init__(self, norm1, attn1, norm2, attn2, norm3, ff):
        super().__init__()
        self.norm1, self.attn1, self.norm2, self.attn2, self.norm3, self.ff = norm1, attn1, norm2, attn2, norm3, ff

    @classmethod
    def random_init(cls, gen, dim, heads, cross_dim, rank=32, precision="int4", device="cuda"):
        kw = dict(rank=rank, precision=precision, device=device)
        return cls(LayerNorm.random_init(dim, device), SDXLAttention.random_init(gen, dim, heads, **kw),
                   LayerNorm.random_init(dim, device),
                   SDXLAttention.random_init(gen, dim, heads, cross_dim=cross_dim, **kw),
                   LayerNorm.random_init(dim, device), SDXLFeedForward.random_init(gen, dim, **kw))

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x)).to(x.dtype)
        x = x + self.attn2(self.norm2(x), context).to(x.dtype)
        return x + self.ff(self.norm3(x)).to(x.dtype)


class SpatialTransformer(nn.Module):
    """diffusers Transformer2DModel: GroupNorm -> proj_in -> blocks ->
    proj_out, plus the input; tokens in (h, w) row-major order."""

    def __init__(self, norm, proj_in, blocks, proj_out):
        super().__init__()
        self.norm = norm
        self.proj_in = proj_in
        self.blocks = nn.ModuleList(blocks)
        self.proj_out = proj_out

    @classmethod
    def random_init(cls, gen, dim, heads, depth, cross_dim, rank=32, precision="int4", device="cuda"):
        return cls(GroupNorm.random_init(dim, device=device), Linear.random_init(gen, dim, dim, device=device),
                   [SDXLTransformerBlock.random_init(gen, dim, heads, cross_dim, rank, precision, device)
                    for _ in range(depth)],
                   Linear.random_init(gen, dim, dim, device=device))

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).reshape(b, c, h * w).transpose(1, 2))
        for blk in self.blocks:
            t = blk(t, context)
        t = self.proj_out(t)
        return x + t.transpose(1, 2).reshape(b, c, h, w).to(x.dtype)


# ---------------------------------------------------------------------------
# resnet and sampling blocks (bf16)
# ---------------------------------------------------------------------------


class ResnetBlock2D(nn.Module):
    def __init__(self, norm1, conv1, time_emb_proj, norm2, conv2, conv_shortcut=None):
        super().__init__()
        self.norm1, self.conv1, self.time_emb_proj = norm1, conv1, time_emb_proj
        self.norm2, self.conv2, self.conv_shortcut = norm2, conv2, conv_shortcut

    @classmethod
    def random_init(cls, gen, cin, cout, temb_dim, device="cuda"):
        return cls(GroupNorm.random_init(cin, device=device), Conv2d.random_init(gen, cin, cout, device=device),
                   Linear.random_init(gen, temb_dim, cout, device=device), GroupNorm.random_init(cout, device=device),
                   Conv2d.random_init(gen, cout, cout, device=device),
                   Conv2d.random_init(gen, cin, cout, k=1, padding=0, device=device) if cin != cout else None)

    def forward(self, x, temb):
        h = self.conv1(_silu_bf16(self.norm1(x)))
        t = self.time_emb_proj(_silu_bf16(temb))
        h = h + t[:, :, None, None].to(h.dtype)
        h = self.conv2(_silu_bf16(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Downsample(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv  # 3x3, stride 2, padding 1

    @classmethod
    def random_init(cls, gen, c, device="cuda"):
        return cls(Conv2d.random_init(gen, c, c, stride=2, padding=1, device=device))

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    @classmethod
    def random_init(cls, gen, c, device="cuda"):
        return cls(Conv2d.random_init(gen, c, c, device=device))

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


# ---------------------------------------------------------------------------
# the UNet
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SDXLConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_layers: tuple = (0, 2, 10)  # per level; 0 = a plain DownBlock2D
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    head_dim: int = 64
    rank: int = 32
    precision: str = "int4"

    @property
    def temb_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def up_skips(self, level: int) -> list[int]:
        """The skip widths the resnets of up level ``level`` concatenate (JAX :461-462)."""
        rev = list(reversed(self.block_out_channels))
        cout = rev[level]
        last = rev[min(level + 1, len(rev) - 1)]
        return [last if i == self.layers_per_block else cout for i in range(self.layers_per_block + 1)]


def _optional_list(mods):
    """An nn.ModuleList that keeps None entries (levels without a
    transformer or sampler), so names stay those of the JAX lists."""
    out = nn.ModuleList()
    for i, m in enumerate(mods):
        out.add_module(str(i), m)
    return out


class SDXLUNet2DConditionModel(nn.Module):
    """SDXL base UNet: down levels (plain, cross-attention, cross-attention),
    mid block, mirrored up levels; SDXL's text_time additional embeddings
    (pooled text + six size / crop ids)."""

    def __init__(self, cfg, conv_in, time_lin1, time_lin2, add_lin1, add_lin2, down_resnets, down_attns,
                 downsamplers, mid_resnets, mid_attn, up_resnets, up_attns, upsamplers, norm_out, conv_out):
        super().__init__()
        self.cfg = cfg
        self.conv_in, self.conv_out, self.norm_out = conv_in, conv_out, norm_out
        self.time_lin1, self.time_lin2, self.add_lin1, self.add_lin2 = time_lin1, time_lin2, add_lin1, add_lin2
        self.down_resnets = nn.ModuleList(nn.ModuleList(r) for r in down_resnets)
        self.down_attns = nn.ModuleList(_optional_list(a) for a in down_attns)
        self.downsamplers = _optional_list(downsamplers)
        self.mid_resnets = nn.ModuleList(mid_resnets)
        self.mid_attn = mid_attn
        self.up_resnets = nn.ModuleList(nn.ModuleList(r) for r in up_resnets)
        self.up_attns = nn.ModuleList(_optional_list(a) for a in up_attns)
        self.upsamplers = _optional_list(upsamplers)

    @classmethod
    def random_init(cls, cfg: SDXLConfig, seed: int = 0, device="cuda"):
        """Random weights with the distributions of the JAX ``random_init``
        (not its bits), made on ``device`` from ``seed``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        ch, temb = cfg.block_out_channels, cfg.temb_dim
        kw = dict(rank=cfg.rank, precision=cfg.precision, device=device)

        def spatial(c, depth):
            return SpatialTransformer.random_init(gen, c, c // cfg.head_dim, depth, cfg.cross_attention_dim, **kw)

        def resnet(cin, cout):
            return ResnetBlock2D.random_init(gen, cin, cout, temb, device)

        down_resnets, down_attns, downsamplers = [], [], []
        cin = ch[0]
        for lvl, cout in enumerate(ch):
            down_resnets.append([resnet(cin if i == 0 else cout, cout) for i in range(cfg.layers_per_block)])
            tl = cfg.transformer_layers[lvl]
            down_attns.append([spatial(cout, tl) if tl else None for _ in range(cfg.layers_per_block)])
            downsamplers.append(Downsample.random_init(gen, cout, device) if lvl < len(ch) - 1 else None)
            cin = cout
        mid_resnets = [resnet(ch[-1], ch[-1]), resnet(ch[-1], ch[-1])]
        mid_attn = spatial(ch[-1], cfg.transformer_layers[-1])
        up_resnets, up_attns, upsamplers = [], [], []
        rev = list(reversed(ch))
        for lvl, cout in enumerate(rev):
            prev = rev[max(lvl - 1, 0)]
            skips = cfg.up_skips(lvl)
            up_resnets.append([resnet((prev if i == 0 else cout) + skips[i], cout)
                               for i in range(cfg.layers_per_block + 1)])
            tl = cfg.transformer_layers[len(ch) - 1 - lvl]
            up_attns.append([spatial(cout, tl) if tl else None for _ in range(cfg.layers_per_block + 1)])
            upsamplers.append(Upsample.random_init(gen, cout, device) if lvl < len(ch) - 1 else None)
        lin = lambda k, n: Linear.random_init(gen, k, n, device=device)
        return cls(cfg, Conv2d.random_init(gen, cfg.in_channels, ch[0], device=device), lin(ch[0], temb),
                   lin(temb, temb), lin(cfg.projection_class_embeddings_input_dim, temb), lin(temb, temb),
                   down_resnets, down_attns, downsamplers, mid_resnets, mid_attn, up_resnets, up_attns, upsamplers,
                   GroupNorm.random_init(ch[0], device=device),
                   Conv2d.random_init(gen, ch[0], cfg.out_channels, device=device))

    def forward(self, sample, timestep, encoder_hidden_states, text_embeds, time_ids):
        """sample (B, C, H, W); timestep (B,); encoder_hidden_states (B, S,
        cross_dim); text_embeds (B, pooled); time_ids (B, 6) -> (B, C_out,
        H, W) bf16."""
        cfg = self.cfg
        x = sample.to(BF16)
        ctx = encoder_hidden_states.to(BF16)
        temb = self.time_lin2(_silu_bf16(self.time_lin1(timestep_embedding(timestep, cfg.block_out_channels[0])
                                                        .to(BF16))))
        b = time_ids.shape[0]
        tids = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
        add = torch.cat([text_embeds, tids.reshape(b, -1).to(text_embeds.dtype)], dim=-1)
        temb = temb + self.add_lin2(_silu_bf16(self.add_lin1(add.to(BF16))))

        x = self.conv_in(x)
        skips = [x]
        for lvl in range(len(cfg.block_out_channels)):
            for res, attn in zip(self.down_resnets[lvl], self.down_attns[lvl]):
                x = res(x, temb)
                if attn is not None:
                    x = attn(x, ctx)
                skips.append(x)
            if self.downsamplers[lvl] is not None:
                x = self.downsamplers[lvl](x)
                skips.append(x)

        x = self.mid_resnets[0](x, temb)
        x = self.mid_attn(x, ctx)
        x = self.mid_resnets[1](x, temb)

        for lvl in range(len(cfg.block_out_channels)):
            for res, attn in zip(self.up_resnets[lvl], self.up_attns[lvl]):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if attn is not None:
                    x = attn(x, ctx)
            if self.upsamplers[lvl] is not None:
                x = self.upsamplers[lvl](x)

        return self.conv_out(_silu_bf16(self.norm_out(x)))
