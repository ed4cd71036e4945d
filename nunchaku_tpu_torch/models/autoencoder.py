"""AutoencoderKL (the FLUX / SDXL VAE): decoder and encoder.

Counterpart of ``nunchaku_tpu/models/autoencoder.py``: ``Conv2d`` and
``_conv``, ``group_norm``, ``ResnetBlock``, ``AttnBlock``, ``Upsample``,
``Downsample``, ``Decoder``, ``Encoder``, ``AutoencoderKL`` (``random_init``
with both halves, ``enable_tiling`` / ``disable_tiling``, ``decode`` whole or
in blended tiles, ``encode`` to the posterior's mode or a sample),
``_tile_blend_mask`` and the diffusers state-dict loader ``load_autoencoder``
(decoder keys, and encoder keys where the file has them). Layout NCHW,
weights (out, in, kh, kw) bf16 and norms bf16, as in the JAX package.

Rounding. The JAX package leaves the convolutions to XLA: bf16 operands,
f32 accumulation, f32 bias, one rounding to bf16. Here they are
``torch.nn.functional.conv2d`` on bf16 operands with f32 accumulation
(cuDNN on the card, oneDNN on the CPU; TF32 does not apply to bf16). oneDNN
adds the bias before its one rounding; PyTorch's cuDNN route rounds the sum
to bf16 and then adds the bias in bf16, a second rounding: within one bf16
ulp of the JAX result per convolution (exact for zero biases, as
``random_init`` makes them). GroupNorm runs in f32 (the
statistics' sums in another order); the single-head mid-block attention
takes the online flash kernel where the JAX package takes its Pallas
kernel (``c % 128 == 0`` and ``h * w >= 1024``), else an f32 einsum softmax:
in the decoder and in the encoder, whose 1024px mid block attends over
16384 tokens of 512 channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention_online

SCALE_FACTOR = 8  # the decoder's spatial upscale (three 2x upsamplers)


def _conv(x, w, b=None, stride=1, padding=1):
    """NCHW convolution, w (out, in, kh, kw): bf16 operands, bf16 result."""
    return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16),
                    stride=stride, padding=padding)


def group_norm(x, weight, bias, groups=32, eps=1e-6):
    """GroupNorm with f32 statistics and affine, result in x's dtype.

    The statistics come from ``torch.var_mean`` over each group, whose
    reduction spreads a group over many blocks; ``F.group_norm``'s CUDA
    kernel gives each (batch, group) one block, 32 blocks for the VAE's
    groups of up to 8M elements (48% of a 1024px decode's device time on
    an H100). The affine then runs as one multiply-add per element with
    per-channel scale and shift, written straight to x's dtype."""
    b, c = x.shape[:2]
    var, mu = torch.var_mean(x.float().reshape(b, groups, -1), dim=-1, correction=0)
    rstd = torch.rsqrt(var + eps).repeat_interleave(c // groups, dim=1)  # (B, C)
    scale = rstd * weight.float()
    shift = bias.float() - mu.repeat_interleave(c // groups, dim=1) * scale
    out = torch.empty_like(x)
    return torch.addcmul(shift[:, :, None, None], x, scale[:, :, None, None], out=out)


def _silu_norm(x, weight, bias):
    """silu(group_norm(x)): silu of the norm's rounded output, computed in f32
    and rounded once (as PyTorch's bf16 silu does), as in the JAX package."""
    return F.silu(group_norm(x, weight, bias))


def _bf16_weight(gen, shape, fan_in, device):
    return (torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)).to(torch.bfloat16)


class Conv2d(nn.Module):
    def __init__(self, weight, bias=None, stride=1, padding=1):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)
        self.stride = stride
        self.padding = padding

    @classmethod
    def random_init(cls, gen, cin, cout, k=3, stride=1, padding=1, device="cuda"):
        w = _bf16_weight(gen, (cout, cin, k, k), cin * k * k, device)
        return cls(w, torch.zeros((cout,), dtype=torch.bfloat16, device=device), stride, padding)

    def forward(self, x):
        return _conv(x, self.weight, self.bias, self.stride, self.padding)


def _norm_params(c, device):
    return (torch.ones((c,), dtype=torch.bfloat16, device=device),
            torch.zeros((c,), dtype=torch.bfloat16, device=device))


class ResnetBlock(nn.Module):
    def __init__(self, norm1_w, norm1_b, conv1, norm2_w, norm2_b, conv2, shortcut=None):
        super().__init__()
        self.register_buffer("norm1_w", norm1_w)
        self.register_buffer("norm1_b", norm1_b)
        self.conv1 = conv1
        self.register_buffer("norm2_w", norm2_w)
        self.register_buffer("norm2_b", norm2_b)
        self.conv2 = conv2
        self.shortcut = shortcut

    @classmethod
    def random_init(cls, gen, cin, cout, device="cuda"):
        return cls(*_norm_params(cin, device), Conv2d.random_init(gen, cin, cout, device=device),
                   *_norm_params(cout, device), Conv2d.random_init(gen, cout, cout, device=device),
                   Conv2d.random_init(gen, cin, cout, k=1, padding=0, device=device) if cin != cout else None)

    def forward(self, x):
        h = self.conv1(_silu_norm(x, self.norm1_w, self.norm1_b))
        h = self.conv2(_silu_norm(h, self.norm2_w, self.norm2_b))
        sc = x if self.shortcut is None else self.shortcut(x)
        return (sc + h).to(x.dtype)  # bf16 operands: added in f32, rounded once


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (diffusers Attention in the VAE)."""

    def __init__(self, norm_w, norm_b, q, k, v, out):
        super().__init__()
        self.register_buffer("norm_w", norm_w)
        self.register_buffer("norm_b", norm_b)
        self.q, self.k, self.v, self.out = q, k, v, out

    @classmethod
    def random_init(cls, gen, c, device="cuda"):
        return cls(*_norm_params(c, device),
                   *[Conv2d.random_init(gen, c, c, k=1, padding=0, device=device) for _ in range(4)])

    def forward(self, x):
        b, c, h, w = x.shape
        hn = group_norm(x, self.norm_w, self.norm_b)
        q = self.q(hn).reshape(b, c, h * w)
        k = self.k(hn).reshape(b, c, h * w)
        v = self.v(hn).reshape(b, c, h * w)
        if c % 128 == 0 and h * w >= 1024:
            # the flash kernel with one head of D = c: at 1024px the whole-
            # image mid block attends over 16384 tokens, whose (S, S) f32
            # scores would take 1 GiB
            o = flash_attention_online(*(t.transpose(1, 2)[:, None] for t in (q, k, v)),
                                       scale=1.0 / math.sqrt(c))
            o = o[:, 0].transpose(1, 2)  # (b, c, hw)
        else:
            attn = torch.softmax(torch.einsum("bcq,bck->bqk", q.float(), k.float()) / math.sqrt(c), dim=-1)
            o = torch.einsum("bqk,bck->bcq", attn, v.float())
        o = self.out(o.reshape(b, c, h, w).to(x.dtype))
        return (x + o).to(x.dtype)


class Upsample(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    @classmethod
    def random_init(cls, gen, c, device="cuda"):
        return cls(Conv2d.random_init(gen, c, c, device=device))

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    """Pad H at the bottom and W at the right by one, then a stride-2,
    padding-0 convolution (diffusers' asymmetric downsampler)."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    @classmethod
    def random_init(cls, gen, c, device="cuda"):
        return cls(Conv2d.random_init(gen, c, c, stride=2, padding=0, device=device))

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Decoder(nn.Module):
    """conv_in, mid (resnet, attention, resnet), up blocks of resnets with an
    upsampler after each but the last, GroupNorm + SiLU, conv_out.
    ``upsamplers[i]`` belongs to up block ``i``."""

    def __init__(self, conv_in, mid_r1, mid_attn, mid_r2, up_blocks, upsamplers, norm_out_w, norm_out_b,
                 conv_out):
        super().__init__()
        self.conv_in = conv_in
        self.mid_r1 = mid_r1
        self.mid_attn = mid_attn
        self.mid_r2 = mid_r2
        self.up_blocks = nn.ModuleList(nn.ModuleList(blocks) for blocks in up_blocks)
        self.upsamplers = nn.ModuleList(upsamplers)
        self.register_buffer("norm_out_w", norm_out_w)
        self.register_buffer("norm_out_b", norm_out_b)
        self.conv_out = conv_out

    @classmethod
    def random_init(cls, gen, latent_channels, block_out_channels, layers_per_block, device="cuda"):
        ch = block_out_channels[-1]
        up_blocks, upsamplers = [], []
        prev = ch
        rev = list(reversed(block_out_channels))
        mid = (ResnetBlock.random_init(gen, ch, ch, device), AttnBlock.random_init(gen, ch, device),
               ResnetBlock.random_init(gen, ch, ch, device))
        for i, c in enumerate(rev):
            blocks = []
            for _ in range(layers_per_block + 1):
                blocks.append(ResnetBlock.random_init(gen, prev, c, device))
                prev = c
            up_blocks.append(blocks)
            if i < len(rev) - 1:
                upsamplers.append(Upsample.random_init(gen, c, device))
        return cls(Conv2d.random_init(gen, latent_channels, ch, device=device), *mid, up_blocks, upsamplers,
                   *_norm_params(block_out_channels[0], device),
                   Conv2d.random_init(gen, block_out_channels[0], 3, device=device))

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_r2(self.mid_attn(self.mid_r1(h)))
        for i, blocks in enumerate(self.up_blocks):
            for blk in blocks:
                h = blk(h)
            if i < len(self.upsamplers):
                h = self.upsamplers[i](h)
        return self.conv_out(_silu_norm(h, self.norm_out_w, self.norm_out_b))


class Encoder(nn.Module):
    """conv_in, down blocks of resnets with a downsampler after each but the
    last, mid (resnet, attention, resnet), GroupNorm + SiLU, conv_out to the
    posterior's 2 x latent moments. ``downsamplers[i]`` belongs to down
    block ``i``."""

    def __init__(self, conv_in, down_blocks, downsamplers, mid_r1, mid_attn, mid_r2, norm_out_w, norm_out_b,
                 conv_out):
        super().__init__()
        self.conv_in = conv_in
        self.down_blocks = nn.ModuleList(nn.ModuleList(blocks) for blocks in down_blocks)
        self.downsamplers = nn.ModuleList(downsamplers)
        self.mid_r1 = mid_r1
        self.mid_attn = mid_attn
        self.mid_r2 = mid_r2
        self.register_buffer("norm_out_w", norm_out_w)
        self.register_buffer("norm_out_b", norm_out_b)
        self.conv_out = conv_out

    @classmethod
    def random_init(cls, gen, latent_channels, block_out_channels, layers_per_block, device="cuda"):
        """conv_out has 2 x ``latent_channels`` outputs (the JAX
        ``random_init`` makes 2 x 16 whatever the latent width)."""
        down_blocks, downsamplers = [], []
        prev = block_out_channels[0]
        conv_in = Conv2d.random_init(gen, 3, prev, device=device)
        for i, c in enumerate(block_out_channels):
            blocks = []
            for _ in range(layers_per_block):
                blocks.append(ResnetBlock.random_init(gen, prev, c, device))
                prev = c
            down_blocks.append(blocks)
            if i < len(block_out_channels) - 1:
                downsamplers.append(Downsample.random_init(gen, c, device))
        ch = block_out_channels[-1]
        return cls(conv_in, down_blocks, downsamplers, ResnetBlock.random_init(gen, ch, ch, device),
                   AttnBlock.random_init(gen, ch, device), ResnetBlock.random_init(gen, ch, ch, device),
                   *_norm_params(ch, device), Conv2d.random_init(gen, ch, 2 * latent_channels, device=device))

    def forward(self, x):
        h = self.conv_in(x)
        for i, blocks in enumerate(self.down_blocks):
            for blk in blocks:
                h = blk(h)
            if i < len(self.downsamplers):
                h = self.downsamplers[i](h)
        h = self.mid_r2(self.mid_attn(self.mid_r1(h)))
        return self.conv_out(_silu_norm(h, self.norm_out_w, self.norm_out_b))


def _tile_blend_mask(size: int, blend: int, *, top, bottom, left, right, device="cpu"):
    """(1, size, size, 1) linear cross-fade weights for one decoded tile:
    1/(blend+1) .. blend/(blend+1) over the overlap on each interior edge;
    the mask-sum normalization of the tiled decode removes the rest."""
    up = ((torch.arange(size, dtype=torch.float32, device=device) + 1.0) / (blend + 1.0)).clamp(max=1.0)
    down = up.flip(0)
    rows = torch.ones((size,), dtype=torch.float32, device=device)
    cols = torch.ones((size,), dtype=torch.float32, device=device)
    if top:
        rows = rows * up
    if bottom:
        rows = rows * down
    if left:
        cols = cols * up
    if right:
        cols = cols * down
    return (rows[:, None] * cols[None, :])[None, :, :, None]


class AutoencoderKL(nn.Module):
    """The KL autoencoder: the decoder, with diffusers-style spatial tiling,
    and the encoder (None for a decoder-only file)."""

    def __init__(self, *, scaling_factor, shift_factor, decoder, encoder=None):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.shift_factor = shift_factor
        self.decoder = decoder
        self.encoder = encoder
        self.tile_latent_size = None  # None: whole-image decode
        self.tile_overlap = 0.25

    @classmethod
    def random_init(cls, seed=0, latent_channels=16, block_out_channels=(128, 256, 512, 512), layers_per_block=2,
                    scaling_factor=0.3611, shift_factor=0.1159, device="cuda"):
        """Random decoder and encoder weights with the distributions of the
        JAX ``random_init`` (not its bits), made on ``device`` from ``seed``;
        the decoder is drawn first, so its weights do not depend on the
        encoder's."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        decoder = Decoder.random_init(gen, latent_channels, block_out_channels, layers_per_block, device)
        encoder = Encoder.random_init(gen, latent_channels, block_out_channels, layers_per_block, device)
        return cls(scaling_factor=scaling_factor, shift_factor=shift_factor, decoder=decoder, encoder=encoder)

    def enable_tiling(self, tile_latent_size: int = 64, overlap: float = 0.25):
        """Decode in overlapping latent tiles (diffusers enable_vae_tiling):
        64-latent (512px) tiles bound the activations' peak at a tile's."""
        self.tile_latent_size = tile_latent_size
        self.tile_overlap = overlap

    def disable_tiling(self):
        self.tile_latent_size = None

    def _factors(self):
        # the factors round to bf16 first, as JAX's weakly typed scalars do
        return (torch.tensor(self.scaling_factor, dtype=torch.bfloat16),
                torch.tensor(self.shift_factor, dtype=torch.bfloat16))

    @torch.no_grad()
    def encode(self, images: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> scaled latents (B, C_lat, H/8, W/8) bf16:
        the posterior's mode, or with ``generator`` a sample
        ``mean + exp(logvar / 2) * N(0, 1)`` (the JAX ``key`` draws other
        noise, so only the mode is comparable across the packages)."""
        if self.encoder is None:
            raise ValueError("this VAE has no encoder (a decoder-only state dict): it cannot encode images")
        x = (images * 2.0 - 1.0).permute(0, 3, 1, 2).to(torch.bfloat16)
        mean, logvar = self.encoder(x).chunk(2, dim=1)
        z = mean
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device).to(mean.dtype)
            z = mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise
        sf, sh = self._factors()
        return (z - sh) * sf

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, C_lat, h, w) scaled latents -> (B, 8h, 8w, 3) f32 in [0, 1]."""
        ts = self.tile_latent_size
        if ts is not None and (z.shape[2] > ts or z.shape[3] > ts):
            return self._decode_tiled(z)
        return self._decode_impl(z)

    def _decode_tiled(self, z):
        """Overlapping latent tiles of one size, blended linearly over the
        overlap; the last tile of a row or column sits flush against the
        edge (diffusers AutoencoderKL.tiled_decode as the JAX package has it)."""
        b, _, h, w = z.shape
        ts, f = self.tile_latent_size, SCALE_FACTOR
        stride = max(int(ts * (1.0 - self.tile_overlap)), 1)
        blend = (ts - stride) * f

        def offsets(extent):
            if extent <= ts:
                return [0]
            return list(range(0, extent - ts, stride)) + [extent - ts]

        rows_off, cols_off = offsets(h), offsets(w)
        out = torch.zeros((b, h * f, w * f, 3), dtype=torch.float32, device=z.device)
        wsum = torch.zeros((1, h * f, w * f, 1), dtype=torch.float32, device=z.device)
        for i in rows_off:
            for j in cols_off:
                dec = self._decode_impl(z[:, :, i:i + ts, j:j + ts])
                mask = _tile_blend_mask(ts * f, blend, top=i > 0, bottom=i != rows_off[-1], left=j > 0,
                                        right=j != cols_off[-1], device=z.device)
                out[:, i * f:(i + ts) * f, j * f:(j + ts) * f] += dec * mask
                wsum[:, i * f:(i + ts) * f, j * f:(j + ts) * f] += mask
        return out / wsum.clamp_min(1e-8)

    def _decode_impl(self, z):
        sf, sh = self._factors()
        img = self.decoder(z.to(torch.bfloat16) / sf + sh)
        return torch.clamp(img.float().permute(0, 2, 3, 1) / 2 + 0.5, 0.0, 1.0)


# ---------------------------------------------------------------------------
# diffusers state-dict loader
# ---------------------------------------------------------------------------


@torch.no_grad()
def load_autoencoder(path_or_tensors, *, scaling_factor=0.3611, shift_factor=0.1159,
                     block_out_channels=(128, 256, 512, 512), layers_per_block=2, latent_channels=16,
                     device="cuda") -> AutoencoderKL:
    """A diffusers ``AutoencoderKL`` safetensors file (or a dict of tensors),
    bf16 (JAX ``load_autoencoder``, autoencoder.py:412). Every decoder
    tensor's shape, and every encoder tensor's where the file has
    ``encoder.*`` keys, is checked against the given structure; a file
    without decoder keys is refused, a decoder-only file loads with
    ``encoder=None`` (``encode`` then raises)."""
    if isinstance(path_or_tensors, dict):
        sd = path_or_tensors
    else:
        from ..utils.safetensors import load_safetensors

        sd, _ = load_safetensors(path_or_tensors)
    if "decoder.conv_in.weight" not in sd:
        raise KeyError("no decoder.* tensors: not a diffusers AutoencoderKL state dict with a decoder")

    def get(name, shape):
        t = sd[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not match the structure's {tuple(shape)}")
        return t.to(device).float().to(torch.bfloat16)

    def conv(prefix, cin, cout, k=3, stride=1, padding=None):
        w = sd[f"{prefix}.weight"]
        if w.ndim == 2:  # diffusers Attention keeps its projections as Linear layers
            w = w[:, :, None, None]
        if tuple(w.shape) != (cout, cin, k, k):
            raise ValueError(f"{prefix}.weight: shape {tuple(w.shape)} does not match the structure's "
                             f"{(cout, cin, k, k)}")
        return Conv2d(w.to(device).float().to(torch.bfloat16), get(f"{prefix}.bias", (cout,)), stride,
                      (1 if k == 3 else 0) if padding is None else padding)

    def resnet(prefix, cin, cout):
        sc = conv(f"{prefix}.conv_shortcut", cin, cout, k=1) if cin != cout else None
        return ResnetBlock(get(f"{prefix}.norm1.weight", (cin,)), get(f"{prefix}.norm1.bias", (cin,)),
                           conv(f"{prefix}.conv1", cin, cout), get(f"{prefix}.norm2.weight", (cout,)),
                           get(f"{prefix}.norm2.bias", (cout,)), conv(f"{prefix}.conv2", cout, cout), sc)

    def attn(prefix, c):
        return AttnBlock(get(f"{prefix}.group_norm.weight", (c,)), get(f"{prefix}.group_norm.bias", (c,)),
                         *[conv(f"{prefix}.{n}", c, c, k=1) for n in ("to_q", "to_k", "to_v", "to_out.0")])

    d = "decoder"
    rev = list(reversed(block_out_channels))
    ch = rev[0]
    up_blocks, upsamplers, prev = [], [], ch
    for i, c in enumerate(rev):
        blocks = []
        for j in range(layers_per_block + 1):
            blocks.append(resnet(f"{d}.up_blocks.{i}.resnets.{j}", prev, c))
            prev = c
        up_blocks.append(blocks)
        if i < len(rev) - 1:
            upsamplers.append(Upsample(conv(f"{d}.up_blocks.{i}.upsamplers.0.conv", c, c)))
    c0 = block_out_channels[0]
    decoder = Decoder(conv(f"{d}.conv_in", latent_channels, ch), resnet(f"{d}.mid_block.resnets.0", ch, ch),
                      attn(f"{d}.mid_block.attentions.0", ch), resnet(f"{d}.mid_block.resnets.1", ch, ch),
                      up_blocks, upsamplers, get(f"{d}.conv_norm_out.weight", (c0,)),
                      get(f"{d}.conv_norm_out.bias", (c0,)), conv(f"{d}.conv_out", c0, 3))

    encoder = None
    if "encoder.conv_in.weight" in sd:
        e = "encoder"
        down_blocks, downsamplers, prev = [], [], c0
        for i, c in enumerate(block_out_channels):
            blocks = []
            for j in range(layers_per_block):
                blocks.append(resnet(f"{e}.down_blocks.{i}.resnets.{j}", prev, c))
                prev = c
            down_blocks.append(blocks)
            if i < len(block_out_channels) - 1:
                downsamplers.append(Downsample(conv(f"{e}.down_blocks.{i}.downsamplers.0.conv", c, c, stride=2,
                                                    padding=0)))
        encoder = Encoder(conv(f"{e}.conv_in", 3, c0), down_blocks, downsamplers,
                          resnet(f"{e}.mid_block.resnets.0", ch, ch), attn(f"{e}.mid_block.attentions.0", ch),
                          resnet(f"{e}.mid_block.resnets.1", ch, ch), get(f"{e}.conv_norm_out.weight", (ch,)),
                          get(f"{e}.conv_norm_out.bias", (ch,)), conv(f"{e}.conv_out", ch, 2 * latent_channels))
    return AutoencoderKL(scaling_factor=scaling_factor, shift_factor=shift_factor, decoder=decoder, encoder=encoder)
