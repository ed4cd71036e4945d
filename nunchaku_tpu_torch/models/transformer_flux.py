"""FLUX.1 transformer.

Counterpart of ``nunchaku_tpu/models/transformers/transformer_flux.py``:
``FluxConfig``, ``FluxTransformerBlock``, ``FluxSingleTransformerBlock`` and
``FluxTransformer2DModel`` with ``embed`` / ``run_dual`` / ``run_singles`` /
``head``, without ControlNet, at the precisions w4a8, int8, int4, nvfp4 and
nvfp4-a8 (w4a8 linears with an nvfp4 checkpoint's e2m1 codes, through the
dequant kernel's e2m1 form and the int8 chain; JAX ``ops/gemm.py:1975``), in
two configurations:

* the default: an f32 residual stream and the unfused attention prologue,
  with dense or, after ``set_attention_impl("blocksparse", sparsity_ratio=)``,
  block-sparse attention (FLUX's high-resolution path);
* the turbo configuration ``bench.py`` serves, after
  ``set_stream_dtype(torch.bfloat16)`` and ``enable_fused_qkv_prep()``: a
  bf16 stream, the qkv/RoPE producer kernel, and for linears the LN +
  modulate + quantize producer feeds (``SVDQW4A4Linear.ln_producer``, JAX
  ``_ln_producer_ok``: int8, and w4a8 unless ``NUNCHAKU_TPU_W4A8_XLA=0``)
  the LayerNorm + AdaLN modulation in the projections' quantize producer
  and the blocks' gated residual adds in the MLP consumer's epilogue (the
  JAX ``FUSED_LN_QUANT`` and ``RES_EPILOGUE`` branches, always on here).
  Other blocks on a bf16 stream (int4, nvfp4, w4a8 on the packed route)
  take the unfused branches, as in the JAX package.

The blocks are stacked, as the JAX scans hold them (:297-298):
``transformer_blocks`` and ``single_transformer_blocks`` are one module each
whose buffers carry a leading layer axis (``linear.stack_modules``), and
``run_dual`` / ``run_singles`` loop over the layers' view modules
(``linear.StackedLayers``): each 4-bit linear reads its layer of the qweight
stack by a device-resident index, and the int8 / w4a8 MLP chain pair gets
both stacks and the index (``gelu_mlp(stacked=...)``, JAX :484-511,
:532-555), so the chain kernels run their stacked modes. The index is
absolute: ``run_dual(start=1)`` passes layer i's index into the whole stack
where JAX slices the stack and counts from 0; the layer read is the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import rope_table_halfsplit
from .attention import FeedForward, FluxAttention, gelu_mlp, permute_qk_halfsplit
from .embeddings import CombinedTimestepEmbeddings, rope_table
from .linear import Linear, StackedLayers, SVDQW4A4Linear, build_stacked
from .normalization import (
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    AdaLayerNormZeroSingle,
    layer_norm,
)


@dataclass(frozen=True)
class FluxConfig:
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    in_channels: int = 64
    out_channels: int = 64
    guidance_embeds: bool = True
    axes_dims_rope: tuple = (16, 56, 56)
    rank: int = 32
    precision: str = "int4"  # the JAX FluxConfig's default (nunchaku's svdq-int4_r32)

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


class FluxTransformerBlock(nn.Module):
    """Dual-stream block: per-stream AdaLN, joint attention, gated MLPs."""

    def __init__(self, norm1, norm1_context, attn, ff, ff_context):
        super().__init__()
        self.norm1 = norm1
        self.norm1_context = norm1_context
        self.attn = attn
        self.ff = ff
        self.ff_context = ff_context

    @classmethod
    def random_init(cls, gen, cfg: FluxConfig, device="cuda"):
        dim = cfg.dim
        return cls(
            AdaLayerNormZero.random_init(gen, dim, cfg.precision, device),
            AdaLayerNormZero.random_init(gen, dim, cfg.precision, device),
            FluxAttention.random_init(gen, dim, cfg.num_attention_heads, cfg.attention_head_dim,
                                      joint=True, rank=cfg.rank, precision=cfg.precision,
                                      device=device),
            FeedForward.random_init(gen, dim, rank=cfg.rank, precision=cfg.precision, device=device),
            FeedForward.random_init(gen, dim, rank=cfg.rank, precision=cfg.precision, device=device),
        )

    def forward(self, img, txt, temb, rot, kv_mask=None, ff_stacked=None):
        """``kv_mask``: optional (B, S_txt + S_img) bool validity of the joint
        attention's keys (Qwen-Image's padded prompts). ``ff_stacked``: the
        ``(ff, ff_context)`` pair of ``gelu_mlp`` stacked tuples (JAX
        ``ff_stacked``), or None."""
        ffs, ffcs = (None, None) if ff_stacked is None else ff_stacked
        sdt = img.dtype
        fused_ln = sdt == torch.bfloat16 and self.attn.to_qkv.ln_producer
        if fused_ln:
            shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1.mod_vectors(temb)
            c_shift_msa, c_scale_msa, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = (
                self.norm1_context.mod_vectors(temb))
            attn_img, attn_txt = self.attn(img, txt, rot,
                                           mods=((scale_msa, shift_msa), (c_scale_msa, c_shift_msa)),
                                           kv_mask=kv_mask)
        else:
            norm_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(img, temb)
            norm_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(txt, temb)
            attn_img, attn_txt = self.attn(norm_img, norm_txt, rot, kv_mask=kv_mask)

        img = (img + gate_msa[:, None] * attn_img.float()).to(sdt)
        if fused_ln:  # the gated residual add rides the MLP consumer's epilogue
            img = self.ff(img, mod=(scale_mlp, shift_mlp), residual=(img, gate_mlp), stacked=ffs)
        else:
            h = layer_norm(img) * (1.0 + scale_mlp[:, None]) + shift_mlp[:, None]
            ff_out = self.ff(h.to(attn_img.dtype), stacked=ffs)
            img = (img + gate_mlp[:, None] * ff_out.float()).to(sdt)

        txt = (txt + c_gate_msa[:, None] * attn_txt.float()).to(sdt)
        if fused_ln:
            txt = self.ff_context(txt, mod=(c_scale_mlp, c_shift_mlp), residual=(txt, c_gate_mlp), stacked=ffcs)
        else:
            h = layer_norm(txt) * (1.0 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
            ffc_out = self.ff_context(h.to(attn_txt.dtype), stacked=ffcs)
            txt = (txt + c_gate_mlp[:, None] * ffc_out.float()).to(sdt)
        return img, txt


class FluxSingleTransformerBlock(nn.Module):
    """Single-stream block: parallel attention and MLP summed through one
    gated output; ``attn_out`` (K = dim) and ``mlp_fc2`` (K = 4 dim) are the
    two halves of the diffusers ``proj_out``."""

    def __init__(self, norm, attn, mlp_fc1, mlp_fc2, attn_out):
        super().__init__()
        self.norm = norm
        self.attn = attn
        self.mlp_fc1 = mlp_fc1
        self.mlp_fc2 = mlp_fc2
        self.attn_out = attn_out

    @classmethod
    def random_init(cls, gen, cfg: FluxConfig, device="cuda"):
        dim = cfg.dim

        def lin(k, n, act_unsigned=False):
            return SVDQW4A4Linear.random_init(gen, k, n, rank=cfg.rank, precision=cfg.precision,
                                              act_unsigned=act_unsigned, device=device)

        return cls(
            AdaLayerNormZeroSingle.random_init(gen, dim, cfg.precision, device),
            FluxAttention.random_init(gen, dim, cfg.num_attention_heads, cfg.attention_head_dim,
                                      joint=False, rank=cfg.rank, precision=cfg.precision,
                                      device=device),
            lin(dim, 4 * dim), lin(4 * dim, dim, act_unsigned=cfg.precision == "int4"), lin(dim, dim),
        )

    def forward(self, x, temb, rot, mlp_stacked=None):
        """``mlp_stacked``: the MLP pair's ``gelu_mlp`` stacked tuple, or None."""
        fused_ln = x.dtype == torch.bfloat16 and self.attn.to_qkv.ln_producer and self.mlp_fc1.ln_producer
        if fused_ln:
            # x + gate * (attn_out + mlp) in the MLP consumer's epilogue:
            # attn_out's main term enters as `extra`, its low-rank branch as
            # (lora_act, proj_up)
            shift, scale, gate = self.norm.mod_vectors(temb)
            attn = self.attn(x, None, rot, mods=((scale, shift), None))
            attn_main, attn_la = self.attn_out.forward_parts(attn)
            return gelu_mlp(self.mlp_fc1, self.mlp_fc2, x, mod=(scale, shift),
                            residual=(x, gate, attn_main, attn_la, self.attn_out.proj_up), stacked=mlp_stacked)
        norm_x, gate = self.norm(x, temb)
        attn = self.attn(norm_x, None, rot)
        mlp = gelu_mlp(self.mlp_fc1, self.mlp_fc2, norm_x, stacked=mlp_stacked)
        out = self.attn_out(attn).float() + mlp.float()
        return (x + gate[:, None] * out).to(x.dtype)


def chain_stacks(stacked: nn.Module, pairs) -> tuple | None:
    """The (fc1, fc2) qweight stacks of each MLP pair of a stacked block
    (``pairs``: attribute paths), when its MLP may take the chain kernels'
    stacked modes (int8, w4a8; JAX ``stk``, :473-476), else None."""
    if getattr(stacked.get_submodule(pairs[0][0]), "precision", None) not in ("int8", "w4a8"):
        return None
    return tuple((stacked.get_submodule(a).qweight, stacked.get_submodule(b).qweight) for a, b in pairs)


DUAL_CHAINS = (("ff.fc1", "ff.fc2"), ("ff_context.fc1", "ff_context.fc2"))
SINGLE_CHAINS = (("mlp_fc1", "mlp_fc2"),)


def run_dual_stack(model: StackedLayers, name: str, img, txt, temb, rot, start=0, stop=None, kv_mask=None):
    """Dual blocks [start, stop) of the stack ``name``: each layer's view,
    its MLP chain pairs given the stacks and the layer's index."""
    views, ids = (d[name] for d in model._layers())
    chains = chain_stacks(getattr(model, name), DUAL_CHAINS)
    for i in range(len(views))[start:stop]:
        ffs = None if chains is None else tuple((*c, ids[i]) for c in chains)
        img, txt = views[i](img, txt, temb, rot, kv_mask=kv_mask, ff_stacked=ffs)
    return img, txt


class FluxTransformer2DModel(StackedLayers, nn.Module):
    """Full FLUX transformer (diffusers forward contract); f32 residual
    stream unless :meth:`set_stream_dtype` says otherwise.
    ``transformer_blocks`` / ``single_transformer_blocks``: stacked blocks
    (``linear.stack_modules`` / ``build_stacked``)."""

    STACKS = ("transformer_blocks", "single_transformer_blocks")

    def __init__(self, cfg: FluxConfig, x_embedder: Linear, context_embedder: Linear,
                 time_text_embed: CombinedTimestepEmbeddings, transformer_blocks,
                 single_transformer_blocks, norm_out: AdaLayerNormContinuous, proj_out: Linear):
        super().__init__()
        self.cfg = cfg
        self.x_embedder = x_embedder
        self.context_embedder = context_embedder
        self.time_text_embed = time_text_embed
        self.transformer_blocks = transformer_blocks
        self.single_transformer_blocks = single_transformer_blocks
        self.norm_out = norm_out
        self.proj_out = proj_out
        self.stream_dtype = torch.float32

    @classmethod
    def random_init(cls, cfg: FluxConfig, seed: int = 0, device="cuda"):
        """Random weights with the distributions of the JAX ``random_init``
        (not its bits), made on ``device`` from ``seed``; each block is drawn
        and copied into its stack in turn (``build_stacked``)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        dim = cfg.dim
        return cls(
            cfg,
            Linear.random_init(gen, cfg.in_channels, dim, device=device),
            Linear.random_init(gen, cfg.joint_attention_dim, dim, device=device),
            CombinedTimestepEmbeddings.random_init(gen, dim, cfg.pooled_projection_dim,
                                                   cfg.guidance_embeds, device),
            build_stacked(lambda i: FluxTransformerBlock.random_init(gen, cfg, device), cfg.num_layers),
            build_stacked(lambda i: FluxSingleTransformerBlock.random_init(gen, cfg, device),
                          cfg.num_single_layers),
            AdaLayerNormContinuous.random_init(gen, dim, device),
            Linear.random_init(gen, dim, cfg.out_channels, device=device),
        )

    def set_stream_dtype(self, dtype) -> "FluxTransformer2DModel":
        """Residual-stream dtype: f32 (default) or bf16, which halves the
        stream's traffic and, for int8 / w4a8 linears, selects the blocks'
        fused producer branches."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"stream dtype must be float32 or bfloat16, got {dtype}")
        self.stream_dtype = dtype
        return self

    def set_attention_impl(self, impl: str = "flashattn2", *, sparsity_ratio: float = 0.0) -> "FluxTransformer2DModel":
        """The attention of every block (JAX :349-372): ``"flashattn2"`` or
        ``"nunchaku-fp16"``, dense flash; ``"blocksparse"``, block-sparse
        attention where each query block skips the fraction ``sparsity_ratio``
        (0 < ratio < 1) of the kv blocks (``ops.attention.select_blocks``)."""
        if impl in ("flashattn2", "nunchaku-fp16"):
            ratio = 0.0
        elif impl == "blocksparse":
            if not 0.0 < sparsity_ratio < 1.0:
                raise ValueError("blocksparse needs 0 < sparsity_ratio < 1")
            ratio = float(sparsity_ratio)
        else:
            raise ValueError(f"unknown attention impl: {impl!r}")
        self.set_on_stacks("attn", sparsity_ratio=ratio)
        return self

    def enable_fused_qkv_prep(self) -> "FluxTransformer2DModel":
        """Permute every QKV projection's q/k channels and the q/k RMSNorm
        weights into half-split rope order and run the attention prologue
        as the qkv/RoPE producer kernel (:func:`permute_qk_halfsplit`).
        The model's outputs are unchanged up to rounding. Once per model:
        a second call raises. The stacks are permuted in place; the layer
        views are rebuilt at the next forward."""
        for name in self.STACKS:
            permute_qk_halfsplit(getattr(self, name).attn)
        self._views = None  # the views copied the attention's prep_fused
        return self

    @property
    def rope_halfsplit(self) -> bool:
        """Whether the blocks take the half-split (cos, sin) rope table: the
        attention modules' own layout, so a block left in the other layout
        raises instead of rotating the wrong channel pairs."""
        return any(getattr(self, name).attn.prep_fused for name in self.STACKS)

    def embed(self, hidden_states, encoder_hidden_states, pooled_projections, timestep, img_ids,
              txt_ids, guidance=None):
        """-> (img, txt in the stream dtype, temb bf16, rot): rot is the
        (S_txt + S_img, D/2, 2) table, or its half-split (cos, sin) pair once
        the fused qkv prologue is on."""
        img = self.x_embedder(hidden_states).to(self.stream_dtype)
        txt = self.context_embedder(encoder_hidden_states).to(self.stream_dtype)
        temb = self.time_text_embed(timestep, pooled_projections, guidance).to(torch.bfloat16)
        rot = rope_table(torch.cat([txt_ids, img_ids], dim=0), self.cfg.axes_dims_rope)
        if self.rope_halfsplit:
            rot = rope_table_halfsplit(rot)
        return img, txt, temb, rot

    def run_dual(self, img, txt, temb, rot, start=0, stop=None):
        """Dual blocks [start, stop) (JAX :451-511)."""
        return run_dual_stack(self, "transformer_blocks", img, txt, temb, rot, start, stop)

    def run_singles(self, x, temb, rot, start=0, stop=None):
        """Single blocks [start, stop) over the [txt; img] stream (JAX :513-555)."""
        views, ids = (d["single_transformer_blocks"] for d in self._layers())
        chains = chain_stacks(self.single_transformer_blocks, SINGLE_CHAINS)
        for i in range(len(views))[start:stop]:
            x = views[i](x, temb, rot, mlp_stacked=None if chains is None else (*chains[0], ids[i]))
        return x

    def head(self, img, temb):
        return self.proj_out(self.norm_out(img.to(torch.bfloat16), temb)).to(torch.bfloat16)

    def forward(self, hidden_states, encoder_hidden_states, pooled_projections, timestep, img_ids,
                txt_ids, guidance=None):
        img, txt, temb, rot = self.embed(hidden_states, encoder_hidden_states, pooled_projections,
                                         timestep, img_ids, txt_ids, guidance)
        img, txt = self.run_dual(img, txt, temb, rot)
        s_txt = txt.shape[1]
        x = self.run_singles(torch.cat([txt, img], dim=1), temb, rot)
        return self.head(x[:, s_txt:], temb)
