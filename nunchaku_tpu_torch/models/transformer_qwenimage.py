"""Qwen-Image transformer (the 20B MMDiT).

Counterpart of ``nunchaku_tpu/models/transformers/transformer_qwenimage.py``
(``QwenImageConfig`` :31, ``QwenImageTransformer2DModel`` :70) without
ControlNet. The Qwen-Image block is the FLUX dual-stream block, so the
model is a stack of ``FluxTransformerBlock``: 60 joint blocks, no
single-stream blocks, conditioning on the timestep alone, text rope
positions that follow the token index, and an optional RMSNorm on the raw
text states. Padded prompts pass ``encoder_hidden_states_mask``; every
query then ignores the padded text keys (the flash kernels' kv-mask forms).
The residual stream is f32, as in the JAX model.

``blocks`` is one stacked ``FluxTransformerBlock`` (buffers with a leading
layer axis), as the JAX ``run_blocks`` scan holds it (:175-228), and
``run_blocks`` loops over its layer views (``linear.StackedLayers``): the
4-bit linears read their layer of the stacks by a device-resident index,
the MLP chain pairs at int8 / w4a8 get both stacks and the index, and the
kv mask is the same for every layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import rope_table_halfsplit
from ..ops.reference import rmsnorm
from .attention import permute_qk_halfsplit
from .embeddings import MLPEmbedder, rope_table, timestep_embedding
from .linear import Linear, StackedLayers, build_stacked
from .normalization import AdaLayerNormContinuous
from .transformer_flux import FluxConfig, FluxTransformerBlock, run_dual_stack


@dataclass(frozen=True)
class QwenImageConfig:
    num_layers: int = 60
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 3584  # Qwen2.5-VL hidden size
    in_channels: int = 64
    out_channels: int = 16
    axes_dims_rope: tuple = (16, 56, 56)
    rank: int = 32
    precision: str = "int4"

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def proj_out_channels(self) -> int:
        """Packed 2x2 patches: proj_out emits 4 * out_channels."""
        return self.out_channels * 4

    def as_flux(self) -> FluxConfig:
        """The block configuration: FLUX dual blocks, no single blocks, no
        pooled text or guidance embedding."""
        return FluxConfig(
            num_layers=self.num_layers, num_single_layers=0, attention_head_dim=self.attention_head_dim,
            num_attention_heads=self.num_attention_heads, joint_attention_dim=self.joint_attention_dim,
            pooled_projection_dim=0, in_channels=self.in_channels, out_channels=self.out_channels,
            guidance_embeds=False, axes_dims_rope=self.axes_dims_rope, rank=self.rank,
            precision=self.precision)


class QwenImageTransformer2DModel(StackedLayers, nn.Module):
    """``blocks``: the stacked joint blocks."""

    STACKS = ("blocks",)

    def __init__(self, cfg: QwenImageConfig, img_in: Linear, txt_in: Linear, time_embed: MLPEmbedder, blocks,
                 norm_out: AdaLayerNormContinuous, proj_out: Linear, txt_norm: torch.Tensor | None = None):
        super().__init__()
        self.cfg = cfg
        self.img_in = img_in
        self.txt_in = txt_in
        self.time_embed = time_embed
        self.blocks = blocks
        self.norm_out = norm_out
        self.proj_out = proj_out
        # RMSNorm weight on the raw text states before txt_in, when the checkpoint has one
        self.register_buffer("txt_norm", txt_norm)

    @classmethod
    def random_init(cls, cfg: QwenImageConfig, seed: int = 0, device="cuda"):
        """Random weights with the distributions of the JAX ``random_init``
        (not its bits), made on ``device`` from ``seed``; no ``txt_norm``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        fcfg = cfg.as_flux()
        return cls(
            cfg,
            Linear.random_init(gen, cfg.in_channels, cfg.dim, device=device),
            Linear.random_init(gen, cfg.joint_attention_dim, cfg.dim, device=device),
            MLPEmbedder.random_init(gen, 256, cfg.dim, device),
            build_stacked(lambda i: FluxTransformerBlock.random_init(gen, fcfg, device), cfg.num_layers),
            AdaLayerNormContinuous.random_init(gen, cfg.dim, device),
            Linear.random_init(gen, cfg.dim, cfg.proj_out_channels, device=device),
        )

    def enable_fused_qkv_prep(self) -> "QwenImageTransformer2DModel":
        """Half-split q/k weights and the qkv/RoPE producer kernel in every
        block (:func:`permute_qk_halfsplit`, in place on the stack); once per
        model."""
        permute_qk_halfsplit(self.blocks.attn)
        self._views = None  # the views copied the attention's prep_fused
        return self

    @property
    def rope_halfsplit(self) -> bool:
        return self.blocks.attn.prep_fused

    def embed(self, hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids=None):
        """-> (img f32, txt f32, temb bf16, rot): rot is the (S_txt + S_img,
        D/2, 2) table, or its half-split (cos, sin) pair after
        :meth:`enable_fused_qkv_prep`. ``txt_ids`` default: the token index
        on every rope axis, of the tokens given (under sequence parallelism
        a rank's shard: the caller passes the global ids)."""
        img = self.img_in(hidden_states).float()
        if self.txt_norm is not None:
            encoder_hidden_states = rmsnorm(encoder_hidden_states, self.txt_norm).to(encoder_hidden_states.dtype)
        txt = self.txt_in(encoder_hidden_states).float()
        temb = self.time_embed(timestep_embedding(timestep * 1000.0, 256)).to(torch.bfloat16)
        if txt_ids is None:
            s_txt = txt.shape[1]
            txt_ids = torch.arange(s_txt, dtype=torch.int32, device=img.device)[:, None].repeat(1, 3)
        rot = rope_table(torch.cat([txt_ids, img_ids], dim=0), self.cfg.axes_dims_rope)
        if self.rope_halfsplit:
            rot = rope_table_halfsplit(rot)
        return img, txt, temb, rot

    def head(self, img, temb):
        return self.proj_out(self.norm_out(img.to(torch.bfloat16), temb)).to(torch.bfloat16)

    def kv_mask_for(self, img, encoder_hidden_states_mask):
        """Joint [txt; img] key validity (B, S_txt + S_img) from a (B, S_txt)
        padded-prompt mask; None without one."""
        if encoder_hidden_states_mask is None:
            return None
        ones = torch.ones((img.shape[0], img.shape[1]), dtype=torch.bool, device=img.device)
        return torch.cat([encoder_hidden_states_mask.to(device=img.device, dtype=torch.bool), ones], dim=1)

    def run_blocks(self, img, txt, temb, rot, start=0, stop=None, kv_mask=None):
        """Joint blocks [start, stop)."""
        return run_dual_stack(self, "blocks", img, txt, temb, rot, start, stop, kv_mask)

    def forward(self, hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids=None,
                encoder_hidden_states_mask=None):
        """(B, S_img, in_channels) latents, (B, S_txt, joint_dim) text states,
        (B,) timesteps, (S_img, 3) ids -> (B, S_img, 4 * out_channels) bf16."""
        img, txt, temb, rot = self.embed(hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids)
        img, _ = self.run_blocks(img, txt, temb, rot, kv_mask=self.kv_mask_for(img, encoder_hidden_states_mask))
        return self.head(img, temb)
