"""DC-AE (Deep Compression Autoencoder, f32c32) for SANA, bf16.

Counterpart of ``nunchaku_tpu/models/dc_ae.py``, all of it: ``DCAEConfig``,
``ResBlock``, ``GLUMBConv``, ``MultiscaleLinearAttention``,
``EfficientViTBlock``, ``DCDownBlock``, ``DCUpBlock``, ``DCAE`` (``encode``
and ``decode``), the diffusers ``AutoencoderDC`` state-dict loader
``load_dc_ae`` (:306; the decoder runs deepest stage first, :353-355) and
the numpy ``synthesize_dcae_state_dict`` (:372), copied so both packages can
load one state dict.

  encoder: conv_in -> stages of ResBlocks or EfficientViTBlocks, each but the
           last ending in a stride-2 convolution (+ a pixel-unshuffle
           group-mean shortcut) -> conv_out to 32 latent channels (+ a
           channel-group-mean shortcut)
  decoder: conv_in from the latents (+ a channel-repeat shortcut), mirrored
           stages entered through nearest-upsample convolutions (+ a repeat
           and pixel-shuffle shortcut), RMSNorm -> SiLU -> conv_out

NCHW, weights (out, in/groups, kh, kw) bf16, as in JAX. Rounding as XLA's:
each convolution takes bf16 operands with f32 sums and rounds once, then
adds its bias in bf16; RMSNorm (over channels, eps 1e-5) and the linear
attention run in f32. As in JAX, the qkv head-group order after the to_q /
to_k / to_v concat (heads x (q | k | v) of head_dim each, the original
EfficientViT layout) is unverified against real files.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.reference import bf16_matmul

BF16 = torch.bfloat16
_SANA_CHANNELS = (128, 256, 512, 512, 1024, 1024)  # dc-ae-f32c32-sana (diffusers AutoencoderDC config)


@dataclass(frozen=True)
class DCAEConfig:
    in_channels: int = 3
    latent_channels: int = 32
    attention_head_dim: int = 32
    block_out_channels: tuple = _SANA_CHANNELS
    encoder_block_types: tuple = ("res", "res", "res", "vit", "vit", "vit")
    decoder_block_types: tuple = ("res", "res", "res", "vit", "vit", "vit")
    encoder_layers_per_block: tuple = (2, 2, 2, 3, 3, 3)
    decoder_layers_per_block: tuple = (3, 3, 3, 3, 3, 3)
    qkv_multiscales: tuple = ((), (), (), (5,), (5,), (5,))
    scaling_factor: float = 0.41407


def _conv(x, w, b=None, *, stride=1, groups=1):
    """NCHW convolution with padding kh // 2: bf16 operands, bf16 result,
    then the bias added in bf16."""
    pad = w.shape[2] // 2
    out = F.conv2d(x.to(BF16), w.to(BF16), stride=stride, padding=pad, groups=groups)
    return out if b is None else out + b.to(BF16)[None, :, None, None]


def _rms_norm_c(x, w, eps=1e-5):
    """RMSNorm over the channel axis of NCHW, f32, in x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=1, keepdim=True) + eps)
    return (out * w.float()[None, :, None, None]).to(x.dtype)


def _silu_bf16(x):
    return F.silu(x.float()).to(BF16)


def _group_mean(x, c):
    """(B, c * g, H, W) -> (B, c, H, W): the mean of each channel group, f32 sums."""
    b, cg, h, w = x.shape
    return x.float().reshape(b, c, cg // c, h, w).mean(dim=2).to(x.dtype)


class ResBlock(nn.Module):
    """conv3x3 -> SiLU -> conv3x3 (no bias) -> RMSNorm, plus the input."""

    def __init__(self, conv1_w, conv1_b, conv2_w, norm_w):
        super().__init__()
        for name, t in (("conv1_w", conv1_w), ("conv1_b", conv1_b), ("conv2_w", conv2_w), ("norm_w", norm_w)):
            self.register_buffer(name, t)

    def forward(self, x):
        h = _conv(_silu_bf16(_conv(x, self.conv1_w, self.conv1_b)), self.conv2_w)
        return x + _rms_norm_c(h, self.norm_w)


class GLUMBConv(nn.Module):
    """1x1 expand (x2) -> SiLU -> 3x3 depthwise -> GLU -> 1x1 (no bias) ->
    RMSNorm, plus the input (diffusers GLUMBConv with norm_type=rms_norm)."""

    def __init__(self, inv_w, inv_b, depth_w, depth_b, point_w, norm_w):
        super().__init__()
        for name, t in (("inv_w", inv_w), ("inv_b", inv_b), ("depth_w", depth_w), ("depth_b", depth_b),
                        ("point_w", point_w), ("norm_w", norm_w)):
            self.register_buffer(name, t)

    def forward(self, x):
        h = _silu_bf16(_conv(x, self.inv_w, self.inv_b))
        h = _conv(h, self.depth_w, self.depth_b, groups=h.shape[1])
        a, gate = h.chunk(2, dim=1)
        h = _conv(a * _silu_bf16(gate), self.point_w)
        return x + _rms_norm_c(h, self.norm_w)


class MultiscaleLinearAttention(nn.Module):
    """SanaMultiscaleLinearAttention: ReLU linear attention over the pixels
    of the qkv projection and of its depthwise-convolved multiscale
    branches, then the output projection, RMSNorm, plus the input."""

    def __init__(self, q_w, k_w, v_w, ms_in_w, ms_out_w, out_w, norm_w, *, head_dim: int):
        super().__init__()
        for name, t in (("q_w", q_w), ("k_w", k_w), ("v_w", v_w), ("out_w", out_w), ("norm_w", norm_w)):
            self.register_buffer(name, t)  # q / k / v / out: (C_out, C_in) linears without bias
        for j, (wi, wo) in enumerate(zip(ms_in_w, ms_out_w)):
            self.register_buffer(f"ms_in_w_{j}", wi)  # depthwise (3C, 1, k, k)
            self.register_buffer(f"ms_out_w_{j}", wo)  # grouped 1x1 (3C, 3 * head_dim, 1, 1)
        self.scales = len(ms_in_w)
        self.head_dim = head_dim

    def forward(self, x):
        b, c, hh, ww = x.shape
        n = hh * ww
        t = x.reshape(b, c, n).transpose(1, 2).to(BF16)  # (B, N, C)
        qkv = torch.cat([bf16_matmul(t, w.t()).to(BF16) for w in (self.q_w, self.k_w, self.v_w)], dim=-1)
        branches = [qkv]
        qkv_img = qkv.transpose(1, 2).reshape(b, 3 * c, hh, ww)
        for j in range(self.scales):
            wi, wo = getattr(self, f"ms_in_w_{j}"), getattr(self, f"ms_out_w_{j}")
            y = _conv(_conv(qkv_img, wi, groups=3 * c), wo, groups=wo.shape[0] // wo.shape[1])
            branches.append(y.reshape(b, 3 * c, n).transpose(1, 2))
        hd = self.head_dim
        outs = []
        for br in branches:
            z = br.reshape(b, n, -1, 3 * hd)  # heads of (q | k | v), each hd wide
            qh = F.relu(z[..., :hd].float()).transpose(1, 2)  # (B, H, N, hd)
            kh = F.relu(z[..., hd:2 * hd].float()).transpose(1, 2)
            vh = z[..., 2 * hd:].float().transpose(1, 2)
            vk = kh.transpose(-1, -2) @ torch.cat([vh, torch.ones_like(vh[..., :1])], dim=-1)  # (B, H, hd, hd + 1)
            num = qh @ vk  # (B, H, N, hd + 1)
            out = num[..., :-1] / (num[..., -1:] + 1e-15)
            outs.append(out.transpose(1, 2).reshape(b, n, -1))
        o = bf16_matmul(torch.cat(outs, dim=-1).to(BF16), self.out_w.t()).to(BF16)
        o = o.transpose(1, 2).reshape(b, c, hh, ww)
        return x + _rms_norm_c(o, self.norm_w)


class EfficientViTBlock(nn.Module):
    def __init__(self, attn: MultiscaleLinearAttention, conv_out: GLUMBConv):
        super().__init__()
        self.attn = attn
        self.conv_out = conv_out

    def forward(self, x):
        return self.conv_out(self.attn(x))


class DCDownBlock(nn.Module):
    """Stride-2 conv3x3, plus the pixel-unshuffled input's channel-group mean."""

    def __init__(self, conv_w, conv_b):
        super().__init__()
        self.register_buffer("conv_w", conv_w)
        self.register_buffer("conv_b", conv_b)

    def forward(self, x):
        h = _conv(x, self.conv_w, self.conv_b, stride=2)
        return h + _group_mean(F.pixel_unshuffle(x, 2), h.shape[1]).to(h.dtype)


class DCUpBlock(nn.Module):
    """Nearest 2x upsample -> conv3x3, plus the channel-repeated input pixel-shuffled."""

    def __init__(self, conv_w, conv_b):
        super().__init__()
        self.register_buffer("conv_w", conv_w)
        self.register_buffer("conv_b", conv_b)

    def forward(self, x):
        c = x.shape[1]
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        h = _conv(up, self.conv_w, self.conv_b)
        y = F.pixel_shuffle(x.repeat_interleave(h.shape[1] * 4 // c, dim=1), 2)
        return h + y.to(h.dtype)


class DCAE(nn.Module):
    """AutoencoderDC counterpart: 32x spatial compression, 32 latent channels."""

    def __init__(self, cfg: DCAEConfig, enc_conv_in_w, enc_conv_in_b, enc_stages, enc_downs, enc_conv_out_w,
                 enc_conv_out_b, dec_conv_in_w, dec_conv_in_b, dec_stages, dec_ups, dec_norm_w, dec_conv_out_w,
                 dec_conv_out_b):
        super().__init__()
        self.cfg = cfg
        for name, t in (("enc_conv_in_w", enc_conv_in_w), ("enc_conv_in_b", enc_conv_in_b),
                        ("enc_conv_out_w", enc_conv_out_w), ("enc_conv_out_b", enc_conv_out_b),
                        ("dec_conv_in_w", dec_conv_in_w), ("dec_conv_in_b", dec_conv_in_b),
                        ("dec_norm_w", dec_norm_w), ("dec_conv_out_w", dec_conv_out_w),
                        ("dec_conv_out_b", dec_conv_out_b)):
            self.register_buffer(name, t)
        self.enc_stages = nn.ModuleList(nn.ModuleList(s) for s in enc_stages)
        self.enc_downs = nn.ModuleList(nn.Identity() if d is None else d for d in enc_downs)
        self.dec_stages = nn.ModuleList(nn.ModuleList(s) for s in dec_stages)  # deepest first
        self.dec_ups = nn.ModuleList(nn.Identity() if u is None else u for u in dec_ups)

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] -> (B, latent, H/32, W/32) bf16, unscaled."""
        x = _conv(images.to(BF16), self.enc_conv_in_w, self.enc_conv_in_b)
        for blocks, down in zip(self.enc_stages, self.enc_downs):
            for blk in blocks:
                x = blk(x)
            x = down(x)
        z = _conv(x, self.enc_conv_out_w, self.enc_conv_out_b)
        return z + _group_mean(x, z.shape[1]).to(z.dtype)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, latent, h, w), unscaled -> (B, 32h, 32w, 3) f32 in [0, 1]."""
        z = latents.to(BF16)
        x = _conv(z, self.dec_conv_in_w, self.dec_conv_in_b)
        x = x + z.repeat_interleave(x.shape[1] // z.shape[1], dim=1).to(x.dtype)
        for blocks, up in zip(self.dec_stages, self.dec_ups):
            x = up(x)
            for blk in blocks:
                x = blk(x)
        x = _silu_bf16(_rms_norm_c(x, self.dec_norm_w))
        x = _conv(x, self.dec_conv_out_w, self.dec_conv_out_b)
        return torch.clamp(x.float() / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    @classmethod
    def random_init(cls, cfg: DCAEConfig | None = None, seed: int = 0, device="cuda"):
        """Weights from :func:`synthesize_dcae_state_dict` (numpy, ``seed``)."""
        cfg = cfg or DCAEConfig()
        return load_dc_ae(synthesize_dcae_state_dict(cfg, seed=seed), cfg, device=device)


# ---------------------------------------------------------------------------
# loader (diffusers AutoencoderDC state-dict layout)
# ---------------------------------------------------------------------------


def _build_block(t, prefix, kind, cfg, scales):
    if kind == "res":
        return ResBlock(t(f"{prefix}.conv1.weight"), t(f"{prefix}.conv1.bias"), t(f"{prefix}.conv2.weight"),
                        t(f"{prefix}.norm.weight"))
    a = f"{prefix}.attn"
    attn = MultiscaleLinearAttention(
        t(f"{a}.to_q.weight"), t(f"{a}.to_k.weight"), t(f"{a}.to_v.weight"),
        [t(f"{a}.to_qkv_multiscale.{j}.proj_in.weight") for j in range(len(scales))],
        [t(f"{a}.to_qkv_multiscale.{j}.proj_out.weight") for j in range(len(scales))],
        t(f"{a}.to_out.weight"), t(f"{a}.norm_out.weight"), head_dim=cfg.attention_head_dim)
    c = f"{prefix}.conv_out"
    glu = GLUMBConv(t(f"{c}.conv_inverted.weight"), t(f"{c}.conv_inverted.bias"), t(f"{c}.conv_depth.weight"),
                    t(f"{c}.conv_depth.bias"), t(f"{c}.conv_point.weight"), t(f"{c}.norm.weight"))
    return EfficientViTBlock(attn, glu)


@torch.no_grad()
def load_dc_ae(path_or_tensors, cfg: DCAEConfig | None = None, device="cuda") -> DCAE:
    """A DCAE from a diffusers AutoencoderDC state dict (dc-ae-f32c32-sana;
    a file, or a dict of numpy arrays or tensors), bf16 on ``device``."""
    cfg = cfg or DCAEConfig()
    if isinstance(path_or_tensors, dict):
        sd = path_or_tensors
    else:
        from ..utils.safetensors import load_safetensors

        sd, _ = load_safetensors(path_or_tensors)

    def t(key):
        a = sd[key]
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
        return a.to(device).float().to(BF16)

    n = len(cfg.block_out_channels)
    enc_stages, enc_downs = [], []
    for i in range(n):
        enc_stages.append([_build_block(t, f"encoder.down_blocks.{i}.{j}", cfg.encoder_block_types[i], cfg,
                                        cfg.qkv_multiscales[i]) for j in range(cfg.encoder_layers_per_block[i])])
        j = cfg.encoder_layers_per_block[i]
        enc_downs.append(DCDownBlock(t(f"encoder.down_blocks.{i}.{j}.conv.weight"),
                                     t(f"encoder.down_blocks.{i}.{j}.conv.bias")) if i < n - 1 else None)
    # decoder.up_blocks.{i} is stage i (block_out[i] channels, 0 outermost); below the deepest, element 0
    # is the upsampler entering the stage (block_out[i + 1] -> block_out[i]) and the blocks follow
    dec_stages, dec_ups = [], []
    for i in range(n):
        off = 1 if i < n - 1 else 0
        dec_stages.append([_build_block(t, f"decoder.up_blocks.{i}.{j + off}", cfg.decoder_block_types[i], cfg,
                                        cfg.qkv_multiscales[i]) for j in range(cfg.decoder_layers_per_block[i])])
        dec_ups.append(DCUpBlock(t(f"decoder.up_blocks.{i}.0.conv.weight"), t(f"decoder.up_blocks.{i}.0.conv.bias"))
                       if off else None)
    return DCAE(cfg, t("encoder.conv_in.weight"), t("encoder.conv_in.bias"), enc_stages, enc_downs,
                t("encoder.conv_out.weight"), t("encoder.conv_out.bias"), t("decoder.conv_in.weight"),
                t("decoder.conv_in.bias"), dec_stages[::-1], dec_ups[::-1], t("decoder.norm_out.weight"),
                t("decoder.conv_out.weight"), t("decoder.conv_out.bias"))


def synthesize_dcae_state_dict(cfg: DCAEConfig | None = None, seed: int = 0) -> dict:
    """A random state dict in the diffusers AutoencoderDC layout, numpy f32
    (the JAX package's function, the same arrays for the same seed)."""
    cfg = cfg or DCAEConfig()
    rng = np.random.default_rng(seed)
    sd = {}

    def w(key, *shape, scale=0.03):
        sd[key] = (rng.normal(size=shape) * scale).astype(np.float32)

    def block(prefix, kind, c, scales, heads):
        if kind == "res":
            w(f"{prefix}.conv1.weight", c, c, 3, 3)
            w(f"{prefix}.conv1.bias", c)
            w(f"{prefix}.conv2.weight", c, c, 3, 3)
            sd[f"{prefix}.norm.weight"] = np.ones(c, np.float32)
            return
        a = f"{prefix}.attn"
        w(f"{a}.to_q.weight", c, c)
        w(f"{a}.to_k.weight", c, c)
        w(f"{a}.to_v.weight", c, c)
        for j, ks in enumerate(scales):
            w(f"{a}.to_qkv_multiscale.{j}.proj_in.weight", 3 * c, 1, ks, ks)
            w(f"{a}.to_qkv_multiscale.{j}.proj_out.weight", 3 * c, c // heads * 3, 1, 1)
        w(f"{a}.to_out.weight", c, c * (1 + len(scales)))
        sd[f"{a}.norm_out.weight"] = np.ones(c, np.float32)
        g = f"{prefix}.conv_out"
        hidden = c * 4
        w(f"{g}.conv_inverted.weight", hidden * 2, c, 1, 1)
        w(f"{g}.conv_inverted.bias", hidden * 2)
        w(f"{g}.conv_depth.weight", hidden * 2, 1, 3, 3)
        w(f"{g}.conv_depth.bias", hidden * 2)
        w(f"{g}.conv_point.weight", c, hidden, 1, 1)
        sd[f"{g}.norm.weight"] = np.ones(c, np.float32)

    ch = cfg.block_out_channels
    heads_of = lambda c: c // cfg.attention_head_dim
    w("encoder.conv_in.weight", ch[0], cfg.in_channels, 3, 3)
    w("encoder.conv_in.bias", ch[0])
    for i, c in enumerate(ch):
        for j in range(cfg.encoder_layers_per_block[i]):
            block(f"encoder.down_blocks.{i}.{j}", cfg.encoder_block_types[i], c, cfg.qkv_multiscales[i], heads_of(c))
        if i < len(ch) - 1:
            j = cfg.encoder_layers_per_block[i]
            w(f"encoder.down_blocks.{i}.{j}.conv.weight", ch[i + 1], c, 3, 3)
            w(f"encoder.down_blocks.{i}.{j}.conv.bias", ch[i + 1])
    w("encoder.conv_out.weight", cfg.latent_channels, ch[-1], 3, 3)
    w("encoder.conv_out.bias", cfg.latent_channels)

    w("decoder.conv_in.weight", ch[-1], cfg.latent_channels, 3, 3)
    w("decoder.conv_in.bias", ch[-1])
    for i, c in enumerate(ch):
        has_up = i < len(ch) - 1
        if has_up:  # the upsampler entering stage i: ch[i + 1] -> ch[i]
            w(f"decoder.up_blocks.{i}.0.conv.weight", c, ch[i + 1], 3, 3)
            w(f"decoder.up_blocks.{i}.0.conv.bias", c)
        off = 1 if has_up else 0
        for j in range(cfg.decoder_layers_per_block[i]):
            block(f"decoder.up_blocks.{i}.{j + off}", cfg.decoder_block_types[i], c, cfg.qkv_multiscales[i],
                  heads_of(c))
    sd["decoder.norm_out.weight"] = np.ones(ch[0], np.float32)
    w("decoder.conv_out.weight", cfg.in_channels, ch[0], 3, 3)
    w("decoder.conv_out.bias", cfg.in_channels)
    return sd
