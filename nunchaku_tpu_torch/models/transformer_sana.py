"""SANA transformer (linear-attention DiT) with SVDQuant linears.

Counterpart of ``nunchaku_tpu/models/transformers/transformer_sana.py``:
``SanaConfig`` (:40), ``lite_la`` (:65, ReLU linear attention over 32-wide
heads in f32, torch ops as XLA ops in JAX), ``SanaLinearAttention`` (:94,
with the perturbed-attention-guidance value projection ``pag_to_v`` and its
row select), ``SanaCrossAttention`` (:145: the online flash kernel at head
dim 112, or the f32 masked softmax under ``cond_mask``, which has no kernel
in JAX either), ``SanaGLUMBConv`` (:195: the inverted W4A4 linear, SiLU, the
3x3 depthwise convolution with f32 output and bias, the GLU fused into the
point linear's activation quantize), ``SanaTransformerBlock`` (:273) and
``SanaTransformer2DModel`` (:311) with its composable stages ``embed``,
``run_blocks`` and ``head``.

The port loops over per-layer modules where JAX scans a stacked block with
``attach_stacked_weights`` (:391), so its GEMMs take each layer's own
weights (the stacked W4A4 mode runs on Z-Image's stacks). A PAG layer
computes both branches over the whole batch and selects rows with
``torch.where``, as JAX does; a layer outside ``pag_layers`` runs no
perturbed branch (JAX's scan computes one for every layer and selects none
of its rows there: the same result). Odd widths (SANA 1.6B's 2240, 5600)
keep padded buffers and logical dims (:class:`~.linear.SVDQW4A4Linear`); the
GLU splits its [value | gate] input at the logical width and the depthwise
convolution sees the logical channels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention_online
from ..ops.quantize import quantize_w4a4_act_fuse_lora
from ..ops.reference import layer_norm
from .embeddings import MLPEmbedder, timestep_embedding
from .linear import PAD_TOKENS, Linear, SVDQW4A4Linear, pad_rows

LA_HEAD_DIM = 32  # the linear attention's head width (the reference's SanaModel.cpp:26)
LA_EPS = 1e-15
BF16 = torch.bfloat16


@dataclass(frozen=True)
class SanaConfig:
    num_layers: int = 20
    num_attention_heads: int = 70  # dim 2240 = 70 * 32
    attention_head_dim: int = 32
    num_cross_attention_heads: int = 20
    cross_attention_head_dim: int = 112
    caption_channels: int = 2304
    in_channels: int = 32
    out_channels: int = 32
    expand_ratio: float = 2.5
    rank: int = 32
    precision: str = "int4"
    # the blocks whose pag_to_v is real (the reference's pag_layers); set by the loader, None without PAG
    pag_layers: tuple[int, ...] | None = None

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def ff_hidden(self) -> int:
        return int(self.dim * self.expand_ratio)


def lite_la(qkv: torch.Tensor, dim: int) -> torch.Tensor:
    """ReLU linear attention over a fused (B, S, 3*dim) qkv, 32-wide heads,
    in f32: ``out = relu(q) (relu(k)^T v) / (relu(q) . sum relu(k) + eps)``
    -> (B, S, dim) bf16."""
    b, s, _ = qkv.shape
    h = dim // LA_HEAD_DIM

    def heads(t):
        return t.reshape(b, s, h, LA_HEAD_DIM).transpose(1, 2).float()

    q, k, v = (heads(t) for t in qkv[..., :3 * dim].chunk(3, dim=-1))
    q, k = F.relu(q), F.relu(k)
    vk = k.transpose(-1, -2) @ v  # (B, H, d, d)
    ksum = k.sum(dim=2)  # (B, H, d)
    num = q @ vk
    den = (q @ ksum[..., None]) + LA_EPS
    return (num / den).transpose(1, 2).reshape(b, s, dim).to(BF16)


def _svdq(gen, k, n, rank, precision, device, bias=True):
    lin = SVDQW4A4Linear.random_init(gen, k, n, rank=rank, precision=precision, device=device)
    if not bias:
        lin.bias = None
    return lin


class SanaLinearAttention(nn.Module):
    def __init__(self, qkv_proj: SVDQW4A4Linear, out_proj: SVDQW4A4Linear, pag_to_v=None):
        super().__init__()
        self.qkv_proj = qkv_proj
        self.out_proj = out_proj
        self.pag_to_v = pag_to_v  # the perturbed branch's value projection

    @classmethod
    def random_init(cls, gen, dim, rank=32, precision="int4", pag=False, device="cuda"):
        return cls(_svdq(gen, dim, 3 * dim, rank, precision, device, bias=False),
                   _svdq(gen, dim, dim, rank, precision, device, bias=False),
                   _svdq(gen, dim, dim, rank, precision, device, bias=False) if pag else None)

    def forward(self, x, *, pag: bool = False, pag_rows=None):
        """``pag``: this layer runs the perturbed branch (identity attention:
        the value projection alone). ``pag_rows``: (B,) bool, the perturbed
        rows; None perturbs the whole batch."""
        want_pag = pag and self.pag_to_v is not None
        if want_pag and pag_rows is None:
            return self.out_proj(self.pag_to_v(x))
        qkv = self.qkv_proj(x)
        out = self.out_proj(lite_la(qkv, qkv.shape[-1] // 3))
        if want_pag:
            ptb = self.out_proj(self.pag_to_v(x))
            out = torch.where(pag_rows.to(out.device)[:, None, None], ptb, out)
        return out


class SanaCrossAttention(nn.Module):
    def __init__(self, q_linear: SVDQW4A4Linear, kv_linear: Linear, out_proj: SVDQW4A4Linear, *, heads,
                 head_dim):
        super().__init__()
        self.q_linear = q_linear
        self.kv_linear = kv_linear  # bf16, as the reference's GEMM_F16 kv_linear
        self.out_proj = out_proj
        self.heads = heads
        self.head_dim = head_dim

    @classmethod
    def random_init(cls, gen, dim, heads, rank=32, precision="int4", device="cuda"):
        return cls(_svdq(gen, dim, dim, rank, precision, device),
                   Linear.random_init(gen, dim, 2 * dim, device=device),
                   _svdq(gen, dim, dim, rank, precision, device), heads=heads, head_dim=dim // heads)

    def forward(self, x, cond, cond_mask=None):
        b, s, _ = x.shape
        s_txt = cond.shape[1]
        d = self.head_dim
        q = self.q_linear(x)
        h = q.shape[-1] // d
        q = q.reshape(b, s, h, d).transpose(1, 2)
        k, v = self.kv_linear(cond.to(BF16)).to(BF16).chunk(2, dim=-1)
        k = k.reshape(b, s_txt, h, d).transpose(1, 2)
        v = v.reshape(b, s_txt, h, d).transpose(1, 2)
        if cond_mask is None:
            o = flash_attention_online(q, k, v, out_bshd=True)
        else:
            # variable text lengths: an f32 softmax under the mask, as in JAX (:178-187)
            scores = (q.float() @ k.float().transpose(-1, -2)) * (d ** -0.5)
            scores = torch.where(cond_mask.to(scores.device)[:, None, None, :], scores, -1e30)
            p = torch.softmax(scores, dim=-1).to(BF16)
            o = (p.float() @ v.float()).to(BF16).transpose(1, 2).reshape(b, s, h * d)
        return self.out_proj(o)


class SanaGLUMBConv(nn.Module):
    def __init__(self, inverted: SVDQW4A4Linear, depth_w, depth_b, point: SVDQW4A4Linear):
        super().__init__()
        self.inverted = inverted  # dim -> 2 * hidden
        self.register_buffer("depth_w", depth_w)  # (2 * hidden, 1, 3, 3) depthwise
        self.register_buffer("depth_b", depth_b)
        self.point = point  # hidden -> dim, the GLU fused into its activation quantize

    @classmethod
    def random_init(cls, gen, dim, hidden, rank=32, precision="int4", device="cuda"):
        w = (torch.randn((2 * hidden, 1, 3, 3), generator=gen, device=device) / 3.0).to(BF16)
        return cls(_svdq(gen, dim, 2 * hidden, rank, precision, device), w,
                   torch.zeros((2 * hidden,), dtype=BF16, device=device),
                   _svdq(gen, hidden, dim, rank, precision, device, bias=False))

    def forward(self, x, hw):
        h_img, w_img = hw
        b, s, _ = x.shape
        y = F.silu(self.inverted(x).float()).to(BF16)
        c2 = y.shape[-1]
        img = y.reshape(b, h_img, w_img, c2).permute(0, 3, 1, 2)
        # bf16 values in an f32 convolution: exact products, f32 sums and output (JAX's
        # preferred_element_type=f32), plus the f32 bias
        conv = F.conv2d(img.float(), self.depth_w.float(), padding=1, groups=c2)
        conv = conv + self.depth_b.float()[None, :, None, None]
        m = b * s
        y2 = conv.permute(0, 2, 3, 1).reshape(m, c2).to(BF16)
        q, a, la = quantize_w4a4_act_fuse_lora(pad_rows(y2, 8 if m <= 8 else PAD_TOKENS), self.point.proj_down,
                                               self.point.smooth, precision=self.point.precision, fuse_glu=True)
        out = self.point.forward_quant(q, a, la)
        return out[:m, :self.point.logical_out].reshape(b, s, -1)


class SanaTransformerBlock(nn.Module):
    def __init__(self, scale_shift_table, attn, cross_attn, ff):
        super().__init__()
        self.register_buffer("scale_shift_table", scale_shift_table)  # (6, dim) f32
        self.attn = attn
        self.cross_attn = cross_attn
        self.ff = ff

    @classmethod
    def random_init(cls, gen, cfg: SanaConfig, pag=False, device="cuda"):
        dim, kw = cfg.dim, dict(rank=cfg.rank, precision=cfg.precision, device=device)
        return cls(torch.randn((6, dim), generator=gen, device=device) * 0.02,
                   SanaLinearAttention.random_init(gen, dim, pag=pag, **kw),
                   SanaCrossAttention.random_init(gen, dim, cfg.num_cross_attention_heads, **kw),
                   SanaGLUMBConv.random_init(gen, dim, cfg.ff_hidden, **kw))

    def forward(self, x, cond, temb6, hw, cond_mask=None, pag=False, pag_rows=None):
        """x (B, S, dim) f32 stream; temb6 (B, 6, dim) f32 from the shared AdaLN-single projection."""
        mods = temb6 + self.scale_shift_table[None].float()
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (mods[:, i][:, None] for i in range(6))
        norm_x = layer_norm(x) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn(norm_x.to(BF16), pag=pag, pag_rows=pag_rows).float()
        x = x + self.cross_attn(x.to(BF16), cond, cond_mask).float()
        norm_x = layer_norm(x) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff(norm_x.to(BF16), hw).float()


class SanaTransformer2DModel(nn.Module):
    """The SANA DiT (diffusers' forward contract): patch-1 latent tokens in,
    velocity tokens out."""

    def __init__(self, cfg, patch_embed, caption_proj, time_embed, time_proj_linear, blocks, scale_shift_table_out,
                 proj_out):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = patch_embed  # in_channels -> dim (a 1x1 patch)
        self.caption_proj = caption_proj  # caption_channels -> dim
        self.time_embed = time_embed  # MLPEmbedder 256 -> dim
        self.time_proj_linear = time_proj_linear  # dim -> 6 * dim, after SiLU
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("scale_shift_table_out", scale_shift_table_out)  # (2, dim) f32
        self.proj_out = proj_out  # dim -> out_channels

    @classmethod
    def random_init(cls, cfg: SanaConfig, seed: int = 0, device="cuda"):
        """Random weights with the distributions of the JAX ``random_init``
        (not its bits), made on ``device`` from ``seed``. With
        ``cfg.pag_layers`` set, every block gets a ``pag_to_v``, as in JAX."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        dim = cfg.dim
        lin = lambda k, n: Linear.random_init(gen, k, n, device=device)
        blocks = [SanaTransformerBlock.random_init(gen, cfg, pag=cfg.pag_layers is not None, device=device)
                  for _ in range(cfg.num_layers)]
        return cls(cfg, lin(cfg.in_channels, dim), lin(cfg.caption_channels, dim),
                   MLPEmbedder.random_init(gen, 256, dim, device), lin(dim, 6 * dim), blocks,
                   torch.randn((2, dim), generator=gen, device=device) * 0.02, lin(dim, cfg.out_channels))

    def embed(self, hidden_states, encoder_hidden_states, timestep):
        """-> (x (B, S, dim) f32, cond (B, S_txt, dim) bf16, temb (B, dim), temb6 (B, 6, dim) f32, side)."""
        b, s, _ = hidden_states.shape
        side = int(round(s ** 0.5))
        x = self.patch_embed(hidden_states).float()
        cond = self.caption_proj(encoder_hidden_states).to(BF16)
        temb = self.time_embed(timestep_embedding(timestep * 1000.0, 256))
        temb6 = self.time_proj_linear(F.silu(temb.float()).to(BF16)).float().reshape(b, 6, -1)
        return x, cond, temb, temb6, side

    def run_blocks(self, x, cond, temb6, side, cond_mask=None, pag=False, start=0, stop=None, pag_layers=None,
                   pag_rows=None):
        """Blocks [start, stop). With ``pag``, the blocks in ``pag_layers``
        (model-global indices; None: every block) run the perturbed branch on
        the rows ``pag_rows`` ((B,) bool; None: all)."""
        stop = self.cfg.num_layers if stop is None else stop
        hw = side if isinstance(side, tuple) else (side, side)
        for i in range(start, stop):
            p = pag and (pag_layers is None or i in pag_layers)
            x = self.blocks[i](x, cond, temb6, hw, cond_mask, p, pag_rows)
        return x

    def head(self, x, temb):
        mods = self.scale_shift_table_out[None].float() + temb[:, None].float()
        shift, scale = mods[:, 0], mods[:, 1]
        out = layer_norm(x) * (1 + scale[:, None]) + shift[:, None]
        return self.proj_out(out.to(BF16)).to(BF16)

    def forward(self, hidden_states, encoder_hidden_states, timestep, cond_mask=None, pag: bool = False,
                pag_layers=None, pag_rows=None):
        """hidden_states (B, S_img, in_channels) patch-1 latent tokens,
        encoder_hidden_states (B, S_txt, caption_channels), timestep (B,)
        -> (B, S_img, out_channels) bf16."""
        x, cond, temb, temb6, side = self.embed(hidden_states, encoder_hidden_states, timestep)
        x = self.run_blocks(x, cond, temb6, side, cond_mask, pag, pag_layers=pag_layers, pag_rows=pag_rows)
        return self.head(x, temb)
