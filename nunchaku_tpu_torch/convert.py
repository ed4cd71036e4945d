"""Carry FLUX, Qwen-Image, SDXL and VAE weights from the JAX package into the port.

``flux_from_jax_params`` (``qwenimage_from_jax_params`` alike) takes the
dotted names of the JAX ``Module.named_parameters()``
(``nunchaku_tpu/core/module.py``) mapped to numpy arrays -- the blocks'
leaves carry a leading layer axis -- and keeps the blocks stacked: each
layer is read from the JAX stacks, built and checked, and copied into the
port's stack (``linear.build_stacked``). Static attributes (precision, the
int4 fc2 layers' unsigned activations, head dim) come from the config, and
every linear's shape is checked against the config's dims.
A model JAX's ``update_lora_params`` changed carries over too: ranks above
``cfg.rank`` that differ per leaf, each SVDQ linear's ``lora_up_unit`` and
``lora_base_rank``, and the AWQ linears' LoRA side branch.
``sdxl_from_jax_params`` does the same for the SDXL UNet (its NHWC
convolution weights transposed to OIHW, its odd-width SVDQ linears kept
padded), ``vae_from_jax_params`` for the VAE decoder, and
``t5_from_jax_params`` / ``clip_from_jax_params`` / ``gemma2_from_jax_params``
for the text encoders. ``sana_from_jax_params`` takes the SANA transformer's
stacked blocks apart into per-layer modules, its odd-width SVDQ linears kept
padded with the config's logical dims. ``zimage_from_jax_params`` keeps the
Z-Image stacks stacked (the port's Z-Image has the JAX layout): each layer
is built and checked, then the layers are stacked again, each 4-bit weight
K-contiguous within its layer as the W4A4 kernel reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import unet_sdxl as U
from .models.attention import FeedForward, FluxAttention
from .models.autoencoder import AttnBlock, AutoencoderKL, Conv2d, Decoder, Downsample, Encoder, ResnetBlock, Upsample
from .models.embeddings import CombinedTimestepEmbeddings, MLPEmbedder
from .models.linear import AWQW4A16Linear, Linear, SVDQW4A4Linear, build_stacked, padded_dims
from .models.normalization import AdaLayerNormContinuous, AdaLayerNormZero, AdaLayerNormZeroSingle
from .models import transformer_sana as S
from .models import transformer_zimage as Z
from .models.loader_sana import CaptionProjection
from .models.text_encoders.clip import CLIPBlock, CLIPTextModel
from .models.text_encoders.gemma2 import Gemma2Encoder, Gemma2Layer
from .models.text_encoders.t5 import T5FF, T5Attention, T5Block, T5EncoderModel
from .models.transformer_flux import (
    FluxConfig,
    FluxSingleTransformerBlock,
    FluxTransformer2DModel,
    FluxTransformerBlock,
)
from .models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
from .ops.reference import is_4bit


def to_torch(a, device="cuda") -> torch.Tensor:
    """numpy array (bf16 as ml_dtypes / JAX stores it) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


class _Params:
    """The JAX parameters by dotted name, read as torch tensors; remembers
    which names were taken, so :meth:`done` can refuse leftovers."""

    def __init__(self, params: dict, device):
        self.params, self.device, self.used = params, device, set()

    def get(self, name, layer=None):
        self.used.add(name)
        a = np.asarray(self.params[name])
        return to_torch(a if layer is None else a[layer], self.device)

    def opt(self, name, layer=None):
        return self.get(name, layer) if name in self.params else None

    def linear(self, prefix, shape=None):
        """A plain linear; ``shape``: the (K, N) its weight must have."""
        lin = Linear(self.get(prefix + ".weight"), self.opt(prefix + ".bias"))
        if shape is not None and tuple(lin.weight.shape) != shape:
            raise ValueError(f"{prefix}: weight {tuple(lin.weight.shape)} does not match the config's {shape}")
        return lin

    def mlp_embedder(self, prefix):
        return MLPEmbedder(self.linear(prefix + ".fc1"), self.linear(prefix + ".fc2"))

    def done(self):
        unused = sorted(set(self.params) - self.used)
        if unused:
            raise KeyError(f"parameters the port does not take: {unused[:8]}")


def _check(prefix, lin, k, n):
    """The config's logical (K, N) against a linear's buffers: an SVDQ
    linear's are padded to K % 256 and N % 128 (odd widths, JAX
    linear.py:148-196) and take (K, N) as their logical dims."""
    want = padded_dims(k, n) if isinstance(lin, SVDQW4A4Linear) else (k, n)
    if (lin.in_features, lin.out_features) != want:
        raise ValueError(f"{prefix}: ({lin.in_features}, {lin.out_features}) does not match "
                         f"the config's ({k}, {n}) (buffers {want})")
    if isinstance(lin, SVDQW4A4Linear):
        lin.logical_in, lin.logical_out = k, n
    return lin


class _BlockReader:
    """Builds the FLUX blocks of one precision (shared by FLUX and Qwen-Image)."""

    def __init__(self, P: _Params, cfg: FluxConfig):
        if cfg.precision not in ("int8", "w4a8", "int4", "nvfp4"):
            raise NotImplementedError(f"precision {cfg.precision!r} is not ported")
        self.P, self.cfg, self.dim = P, cfg, cfg.dim
        self.unsigned_fc2 = cfg.precision == "int4"  # an int4 model's post-GELU layers take unsigned activations

    def svdq(self, prefix, layer, k, n, act_unsigned=False, precision=None):
        """An SVDQ linear at any rank; after JAX's ``update_lora_params`` its
        ``lora_up_unit`` too, the LoRA rows being the last of ``proj_up``'s
        (so ``lora_base_rank`` = its rows less the unit's)."""
        P = self.P
        proj_up, unit = P.get(prefix + ".proj_up", layer), P.opt(prefix + ".lora_up_unit", layer)
        return _check(prefix, SVDQW4A4Linear(
            P.get(prefix + ".qweight", layer), P.get(prefix + ".wscales", layer),
            P.get(prefix + ".smooth", layer), P.get(prefix + ".proj_down", layer),
            proj_up, P.opt(prefix + ".bias", layer),
            P.opt(prefix + ".rescales", layer), precision=precision or self.cfg.precision,
            act_unsigned=act_unsigned, lora_up_unit=unit,
            lora_base_rank=None if unit is None else proj_up.shape[0] - unit.shape[0]), k, n)

    def mod(self, prefix, layer, n):
        """The modulation linear: AWQ at int4 / nvfp4 (with its LoRA side
        branch where JAX's has one), int8 SVDQ otherwise."""
        P = self.P
        if is_4bit(self.cfg.precision):
            return _check(prefix, AWQW4A16Linear(
                P.get(prefix + ".qweight", layer), P.get(prefix + ".wscales", layer),
                P.get(prefix + ".wzeros", layer), P.opt(prefix + ".bias", layer),
                *(P.opt(f"{prefix}.{name}", layer) for name in ("lora_down", "lora_up", "lora_up_unit"))),
                self.dim, n)
        return self.svdq(prefix, layer, self.dim, n, precision="int8")

    def attn(self, prefix, layer, joint):
        dim, P = self.dim, self.P
        kw = dict(head_dim=self.cfg.attention_head_dim)
        qkv = self.svdq(prefix + ".to_qkv", layer, dim, 3 * dim)
        nq, nk = P.get(prefix + ".norm_q", layer), P.get(prefix + ".norm_k", layer)
        if not joint:
            return FluxAttention(qkv, nq, nk, **kw)
        return FluxAttention(
            qkv, nq, nk, to_out=self.svdq(prefix + ".to_out", layer, dim, dim),
            add_qkv_proj=self.svdq(prefix + ".add_qkv_proj", layer, dim, 3 * dim),
            norm_added_q=P.get(prefix + ".norm_added_q", layer),
            norm_added_k=P.get(prefix + ".norm_added_k", layer),
            to_add_out=self.svdq(prefix + ".to_add_out", layer, dim, dim), **kw)

    def ff(self, prefix, layer):
        return FeedForward(self.svdq(prefix + ".fc1", layer, self.dim, 4 * self.dim),
                           self.svdq(prefix + ".fc2", layer, 4 * self.dim, self.dim, self.unsigned_fc2))

    def dual(self, t, i):
        """Dual block ``i`` of the stacked blocks named ``t``."""
        return FluxTransformerBlock(
            AdaLayerNormZero(self.mod(t + ".norm1.linear", i, 6 * self.dim)),
            AdaLayerNormZero(self.mod(t + ".norm1_context.linear", i, 6 * self.dim)),
            self.attn(t + ".attn", i, True), self.ff(t + ".ff", i), self.ff(t + ".ff_context", i))

    def single(self, t, i):
        dim = self.dim
        return FluxSingleTransformerBlock(
            AdaLayerNormZeroSingle(self.mod(t + ".norm.linear", i, 3 * dim)),
            self.attn(t + ".attn", i, False),
            self.svdq(t + ".mlp_fc1", i, dim, 4 * dim), self.svdq(t + ".mlp_fc2", i, 4 * dim, dim, self.unsigned_fc2),
            self.svdq(t + ".attn_out", i, dim, dim))


def flux_from_jax_params(params: dict, cfg: FluxConfig, device="cuda") -> FluxTransformer2DModel:
    P = _Params(params, device)
    R = _BlockReader(P, cfg)
    dual = build_stacked(lambda i: R.dual("transformer_blocks", i), cfg.num_layers)
    single = build_stacked(lambda i: R.single("single_transformer_blocks", i), cfg.num_single_layers)
    te = "time_text_embed"
    guidance = P.mlp_embedder(te + ".guidance_embedder") if cfg.guidance_embeds else None
    model = FluxTransformer2DModel(
        cfg, P.linear("x_embedder"), P.linear("context_embedder"),
        CombinedTimestepEmbeddings(P.mlp_embedder(te + ".timestep_embedder"),
                                   P.mlp_embedder(te + ".text_embedder"), guidance),
        dual, single, AdaLayerNormContinuous(P.linear("norm_out.linear")), P.linear("proj_out"))
    P.done()
    return model


def qwenimage_from_jax_params(params: dict, cfg: QwenImageConfig, device="cuda") -> QwenImageTransformer2DModel:
    """The port's Qwen-Image model from the JAX model's parameters (its
    stacked ``blocks`` are FLUX dual blocks; ``txt_norm`` when it has one)."""
    P = _Params(params, device)
    R = _BlockReader(P, cfg.as_flux())
    blocks = build_stacked(lambda i: R.dual("blocks", i), cfg.num_layers)
    model = QwenImageTransformer2DModel(
        cfg, P.linear("img_in", (cfg.in_channels, cfg.dim)), P.linear("txt_in", (cfg.joint_attention_dim, cfg.dim)),
        P.mlp_embedder("time_embed"), blocks, AdaLayerNormContinuous(P.linear("norm_out.linear")),
        P.linear("proj_out", (cfg.dim, cfg.proj_out_channels)), P.opt("txt_norm"))
    P.done()
    return model


def sdxl_from_jax_params(params: dict, cfg: U.SDXLConfig, device="cuda") -> U.SDXLUNet2DConditionModel:
    """The port's SDXL UNet from the JAX ``SDXLUNet2DConditionModel``'s
    parameters: the same names, convolution weights (kh, kw, in, out) ->
    (out, in, kh, kw), every linear and convolution checked against the
    config's widths (the SVDQ linears by their logical dims)."""
    P = _Params(params, device)
    ch, temb = cfg.block_out_channels, cfg.temb_dim

    def conv(prefix, cin, cout, k=3, stride=1):
        w = P.get(prefix + ".weight")
        if tuple(w.shape) != (k, k, cin, cout):
            raise ValueError(f"{prefix}.weight: {tuple(w.shape)} does not match the config's {(k, k, cin, cout)}")
        return Conv2d(w.permute(3, 2, 0, 1).contiguous(), P.opt(prefix + ".bias"), stride, k // 2)

    def norm(cls, prefix):
        return cls(P.get(prefix + ".gamma"), P.get(prefix + ".beta"))

    def svdq(prefix, k, n):
        return _check(prefix, SVDQW4A4Linear(
            P.get(prefix + ".qweight"), P.get(prefix + ".wscales"), P.get(prefix + ".smooth"),
            P.get(prefix + ".proj_down"), P.get(prefix + ".proj_up"), P.opt(prefix + ".bias"),
            P.opt(prefix + ".rescales"), precision=cfg.precision), k, n)

    def block(prefix, dim):
        a1, a2 = prefix + ".attn1", prefix + ".attn2"
        attn1 = U.SDXLAttention(to_qkv=svdq(a1 + ".to_qkv", dim, 3 * dim), to_out=svdq(a1 + ".to_out", dim, dim),
                                head_dim=cfg.head_dim)
        cross = (cfg.cross_attention_dim, dim)
        attn2 = U.SDXLAttention(to_q=svdq(a2 + ".to_q", dim, dim), to_k=P.linear(a2 + ".to_k", cross),
                                to_v=P.linear(a2 + ".to_v", cross), to_out=svdq(a2 + ".to_out", dim, dim),
                                head_dim=cfg.head_dim)
        ff = U.SDXLFeedForward(svdq(prefix + ".ff.proj", dim, 8 * dim), svdq(prefix + ".ff.out", 4 * dim, dim))
        return U.SDXLTransformerBlock(norm(U.LayerNorm, prefix + ".norm1"), attn1, norm(U.LayerNorm, prefix + ".norm2"),
                                      attn2, norm(U.LayerNorm, prefix + ".norm3"), ff)

    def spatial(prefix, dim, depth):
        return U.SpatialTransformer(norm(U.GroupNorm, prefix + ".norm"), P.linear(prefix + ".proj_in", (dim, dim)),
                                    [block(f"{prefix}.blocks.{j}", dim) for j in range(depth)],
                                    P.linear(prefix + ".proj_out", (dim, dim)))

    def resnet(prefix, cin, cout):
        sc = conv(prefix + ".conv_shortcut", cin, cout, k=1) if cin != cout else None
        return U.ResnetBlock2D(norm(U.GroupNorm, prefix + ".norm1"), conv(prefix + ".conv1", cin, cout),
                               P.linear(prefix + ".time_emb_proj", (temb, cout)), norm(U.GroupNorm, prefix + ".norm2"),
                               conv(prefix + ".conv2", cout, cout), sc)

    down_resnets, down_attns, downsamplers = [], [], []
    cin = ch[0]
    for lvl, cout in enumerate(ch):
        down_resnets.append([resnet(f"down_resnets.{lvl}.{i}", cin if i == 0 else cout, cout)
                             for i in range(cfg.layers_per_block)])
        tl = cfg.transformer_layers[lvl]
        down_attns.append([spatial(f"down_attns.{lvl}.{i}", cout, tl) if tl else None
                           for i in range(cfg.layers_per_block)])
        downsamplers.append(U.Downsample(conv(f"downsamplers.{lvl}.conv", cout, cout, stride=2))
                            if lvl < len(ch) - 1 else None)
        cin = cout
    mid_resnets = [resnet(f"mid_resnets.{i}", ch[-1], ch[-1]) for i in range(2)]
    mid_attn = spatial("mid_attn", ch[-1], cfg.transformer_layers[-1])  # built even at depth 0, as in JAX
    up_resnets, up_attns, upsamplers = [], [], []
    rev = list(reversed(ch))
    for lvl, cout in enumerate(rev):
        prev, skips = rev[max(lvl - 1, 0)], cfg.up_skips(lvl)
        tl = cfg.transformer_layers[len(ch) - 1 - lvl]
        up_resnets.append([resnet(f"up_resnets.{lvl}.{i}", (prev if i == 0 else cout) + skips[i], cout)
                           for i in range(cfg.layers_per_block + 1)])
        up_attns.append([spatial(f"up_attns.{lvl}.{i}", cout, tl) if tl else None
                         for i in range(cfg.layers_per_block + 1)])
        upsamplers.append(U.Upsample(conv(f"upsamplers.{lvl}.conv", cout, cout)) if lvl < len(ch) - 1 else None)
    model = U.SDXLUNet2DConditionModel(
        cfg, conv("conv_in", cfg.in_channels, ch[0]), P.linear("time_lin1", (ch[0], temb)),
        P.linear("time_lin2", (temb, temb)), P.linear("add_lin1", (cfg.projection_class_embeddings_input_dim, temb)),
        P.linear("add_lin2", (temb, temb)), down_resnets, down_attns, downsamplers, mid_resnets, mid_attn,
        up_resnets, up_attns, upsamplers, norm(U.GroupNorm, "norm_out"), conv("conv_out", ch[0], cfg.out_channels))
    P.done()
    return model


def vae_from_jax_params(params: dict, *, latent_channels=16, block_out_channels=(128, 256, 512, 512),
                        layers_per_block=2, scaling_factor=0.3611, shift_factor=0.1159,
                        device="cuda") -> AutoencoderKL:
    """The port's VAE from the JAX ``AutoencoderKL.named_parameters()``,
    every shape checked against the given structure: the decoder, and the
    encoder where ``encoder.*`` leaves are present (else ``encoder=None``).
    Any name the structure does not take raises."""
    used = set()

    def get(name, shape):
        used.add(name)
        a = np.asarray(params[name])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not match the structure's {tuple(shape)}")
        return to_torch(a, device)

    def conv(prefix, cin, cout, k=3, stride=1, padding=None):
        return Conv2d(get(prefix + ".weight", (cout, cin, k, k)), get(prefix + ".bias", (cout,)), stride,
                      (1 if k == 3 else 0) if padding is None else padding)

    def vec(name, c):
        return get(name, (c,))

    def resnet(prefix, cin, cout):
        sc = conv(prefix + ".shortcut", cin, cout, k=1) if cin != cout else None
        return ResnetBlock(vec(prefix + ".norm1_w", cin), vec(prefix + ".norm1_b", cin),
                           conv(prefix + ".conv1", cin, cout), vec(prefix + ".norm2_w", cout),
                           vec(prefix + ".norm2_b", cout), conv(prefix + ".conv2", cout, cout), sc)

    def attn(a, c):
        return AttnBlock(vec(a + ".norm_w", c), vec(a + ".norm_b", c),
                         *[conv(f"{a}.{n}", c, c, k=1) for n in ("q", "k", "v", "out")])

    d = "decoder"
    ch = block_out_channels[-1]
    c0 = block_out_channels[0]
    rev = list(reversed(block_out_channels))
    up_blocks, upsamplers, prev = [], [], ch
    for i, c in enumerate(rev):
        blocks = []
        for j in range(layers_per_block + 1):
            blocks.append(resnet(f"{d}.up_blocks.{i}.{j}", prev, c))
            prev = c
        up_blocks.append(blocks)
        if i < len(rev) - 1:
            upsamplers.append(Upsample(conv(f"{d}.upsamplers.{i}.conv", c, c)))
    decoder = Decoder(
        conv(d + ".conv_in", latent_channels, ch), resnet(d + ".mid_r1", ch, ch), attn(d + ".mid_attn", ch),
        resnet(d + ".mid_r2", ch, ch), up_blocks, upsamplers,
        vec(d + ".norm_out_w", c0), vec(d + ".norm_out_b", c0), conv(d + ".conv_out", c0, 3))

    encoder = None
    if "encoder.conv_in.weight" in params:
        e = "encoder"
        down_blocks, downsamplers, prev = [], [], c0
        for i, c in enumerate(block_out_channels):
            blocks = []
            for j in range(layers_per_block):
                blocks.append(resnet(f"{e}.down_blocks.{i}.{j}", prev, c))
                prev = c
            down_blocks.append(blocks)
            if i < len(block_out_channels) - 1:
                downsamplers.append(Downsample(conv(f"{e}.downsamplers.{i}.conv", c, c, stride=2, padding=0)))
        encoder = Encoder(
            conv(e + ".conv_in", 3, c0), down_blocks, downsamplers, resnet(e + ".mid_r1", ch, ch),
            attn(e + ".mid_attn", ch), resnet(e + ".mid_r2", ch, ch), vec(e + ".norm_out_w", ch),
            vec(e + ".norm_out_b", ch), conv(e + ".conv_out", ch, 2 * latent_channels))
    unused = sorted(set(params) - used)
    if unused:
        raise KeyError(f"parameters the port does not take: {unused[:8]}")
    return AutoencoderKL(scaling_factor=scaling_factor, shift_factor=shift_factor, decoder=decoder, encoder=encoder)


def t5_from_jax_params(params: dict, *, heads: int, d_kv: int, device="cuda") -> T5EncoderModel:
    """The port's T5 encoder from the JAX ``T5EncoderModel.named_parameters()``
    (``blocks.{i}.*``, ``embed_tokens``, ``final_norm.weight``): a linear is
    AWQ W4A16 where it has a ``qweight``, else plain bf16."""
    P = _Params(params, device)
    layers = 1 + max(int(n.split(".")[1]) for n in params if n.startswith("blocks."))

    def lin(prefix):
        if prefix + ".qweight" in params:
            return AWQW4A16Linear(P.get(prefix + ".qweight"), P.get(prefix + ".wscales"), P.get(prefix + ".wzeros"),
                                  P.opt(prefix + ".bias"))
        return P.linear(prefix)

    blocks = []
    for i in range(layers):
        a, f = f"blocks.{i}.attn", f"blocks.{i}.ff"
        attn = T5Attention(lin(a + ".q"), lin(a + ".k"), lin(a + ".v"), lin(a + ".o"), heads=heads, d_kv=d_kv,
                           rel_bias=P.opt(a + ".rel_bias"))
        blocks.append(T5Block(P.get(f"blocks.{i}.ln1.weight"), attn, P.get(f"blocks.{i}.ln2.weight"),
                              T5FF(lin(f + ".wi_0"), lin(f + ".wi_1"), lin(f + ".wo"))))
    if blocks[0].attn.rel_bias is None:
        raise KeyError("blocks.0.attn.rel_bias: block 0 holds the shared position bias")
    model = T5EncoderModel(P.get("embed_tokens"), blocks, P.get("final_norm.weight"), heads=heads, d_kv=d_kv)
    P.done()
    return model


def clip_from_jax_params(params: dict, *, heads: int, eos_token_id: int = 2, device="cuda") -> CLIPTextModel:
    """The port's CLIP text encoder from the JAX ``CLIPTextModel.named_parameters()``."""
    P = _Params(params, device)
    layers = 1 + max(int(n.split(".")[1]) for n in params if n.startswith("blocks."))
    blocks = []
    for i in range(layers):
        p = f"blocks.{i}."
        blocks.append(CLIPBlock(P.get(p + "ln1_w"), P.get(p + "ln1_b"), *[P.linear(p + n) for n in "qkvo"],
                                P.get(p + "ln2_w"), P.get(p + "ln2_b"), P.linear(p + "fc1"), P.linear(p + "fc2"),
                                heads=heads))
    model = CLIPTextModel(P.get("token_embedding"), P.get("position_embedding"), blocks, P.get("final_ln_w"),
                          P.get("final_ln_b"), eos_token_id=eos_token_id)
    P.done()
    return model


def sana_from_jax_params(params: dict, cfg: S.SanaConfig, device="cuda") -> S.SanaTransformer2DModel:
    """The port's SANA transformer from the JAX ``SanaTransformer2DModel``'s
    parameters: the stacked ``blocks.*`` leaves (leading layer axis) become
    ``blocks.{i}.*``; every linear is checked against the config's widths
    (the SVDQ linears by their logical dims); a loaded model's
    ``CaptionProjection`` (``caption_proj.fc1`` / ``fc2``) is kept."""
    P = _Params(params, device)
    dim, hid = cfg.dim, cfg.ff_hidden

    def svdq(prefix, layer, k, n):
        return _check(prefix, SVDQW4A4Linear(
            P.get(prefix + ".qweight", layer), P.get(prefix + ".wscales", layer), P.get(prefix + ".smooth", layer),
            P.get(prefix + ".proj_down", layer), P.get(prefix + ".proj_up", layer), P.opt(prefix + ".bias", layer),
            P.opt(prefix + ".rescales", layer), precision=cfg.precision), k, n)

    blocks = []
    for i in range(cfg.num_layers):
        a, c, f = "blocks.attn", "blocks.cross_attn", "blocks.ff"
        pag = svdq(a + ".pag_to_v", i, dim, dim) if a + ".pag_to_v.qweight" in params else None
        attn = S.SanaLinearAttention(svdq(a + ".qkv_proj", i, dim, 3 * dim), svdq(a + ".out_proj", i, dim, dim), pag)
        kv = Linear(P.get(c + ".kv_linear.weight", i), P.opt(c + ".kv_linear.bias", i))
        if tuple(kv.weight.shape) != (dim, 2 * dim):
            raise ValueError(f"{c}.kv_linear: weight {tuple(kv.weight.shape)} does not match the config's "
                             f"{(dim, 2 * dim)}")
        cross = S.SanaCrossAttention(svdq(c + ".q_linear", i, dim, dim), kv, svdq(c + ".out_proj", i, dim, dim),
                                     heads=cfg.num_cross_attention_heads, head_dim=dim // cfg.num_cross_attention_heads)
        ff = S.SanaGLUMBConv(svdq(f + ".inverted", i, dim, 2 * hid), P.get(f + ".depth_w", i), P.get(f + ".depth_b", i),
                             svdq(f + ".point", i, hid, dim))
        blocks.append(S.SanaTransformerBlock(P.get("blocks.scale_shift_table", i), attn, cross, ff))
    if "caption_proj.fc1.weight" in params:
        caption = CaptionProjection(P.linear("caption_proj.fc1", (cfg.caption_channels, dim)),
                                    P.linear("caption_proj.fc2", (dim, dim)))
    else:
        caption = P.linear("caption_proj", (cfg.caption_channels, dim))
    model = S.SanaTransformer2DModel(
        cfg, P.linear("patch_embed", (cfg.in_channels, dim)), caption, P.mlp_embedder("time_embed"),
        P.linear("time_proj_linear", (dim, 6 * dim)), blocks, P.get("scale_shift_table_out"),
        P.linear("proj_out", (dim, cfg.out_channels)))
    P.done()
    return model


def zimage_from_jax_params(params: dict, cfg: Z.ZImageConfig, device="cuda") -> Z.ZImageTransformer2DModel:
    """The port's Z-Image transformer from the JAX model's parameters (the
    stacks' leaves carry a leading layer axis). Quantized linears are held
    to the config's dims; 16-bit refiner linears (``skip_refiners``) are
    taken where a stack has ``weight`` for ``qweight``; the timestep and
    modulation linears keep the shapes they have (a loaded file's
    ``t_embedder`` is 1024 wide at any dim, ``random_init``'s ``t_dim``)."""
    P = _Params(params, device)
    dim, inner = cfg.dim, cfg.inner_ffn

    def lin(prefix, layer, k, n):
        if prefix + ".qweight" not in params:
            out = Linear(P.get(prefix + ".weight", layer), P.opt(prefix + ".bias", layer))
            if tuple(out.weight.shape) != (k, n):
                raise ValueError(f"{prefix}: weight {tuple(out.weight.shape)} does not match the config's {(k, n)}")
            return out
        return _check(prefix, SVDQW4A4Linear(
            P.get(prefix + ".qweight", layer), P.get(prefix + ".wscales", layer), P.get(prefix + ".smooth", layer),
            P.get(prefix + ".proj_down", layer), P.get(prefix + ".proj_up", layer), P.opt(prefix + ".bias", layer),
            P.opt(prefix + ".rescales", layer), precision=cfg.precision), k, n)

    def block(t, i, modulated):
        attn = Z.ZImageAttention(lin(t + ".attention.to_qkv", i, dim, 3 * dim), P.get(t + ".attention.norm_q", i),
                                 P.get(t + ".attention.norm_k", i), lin(t + ".attention.to_out", i, dim, dim),
                                 heads=cfg.num_attention_heads, head_dim=cfg.head_dim)
        ff = Z.ZImageFeedForward(lin(t + ".feed_forward.w13", i, dim, 2 * inner),
                                 lin(t + ".feed_forward.w2", i, inner, dim))
        adaln = Linear(P.get(t + ".adaln.weight", i), P.opt(t + ".adaln.bias", i)) if modulated else None
        return Z.ZImageTransformerBlock(attn, ff, *(P.get(f"{t}.{n}", i) for n in (
            "attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2")), adaln, eps=cfg.norm_eps)

    def stack(t, n, modulated):
        return build_stacked(lambda i: block(t, i, modulated), n)

    patch_dim = cfg.in_channels * cfg.patch_size ** 2
    model = Z.ZImageTransformer2DModel(
        cfg, P.linear("x_embedder", (patch_dim, dim)), P.linear("t_embedder1"), P.linear("t_embedder2"),
        P.get("cap_norm"), P.linear("cap_embedder", (cfg.cap_feat_dim, dim)),
        stack("noise_refiner", cfg.num_refiner_layers, True), stack("context_refiner", cfg.num_refiner_layers, False),
        stack("layers", cfg.num_layers, True), P.get("norm_out"), P.linear("proj_out", (dim, patch_dim)),
        P.linear("adaln_out"))
    P.done()
    return model


def gemma2_from_jax_params(params: dict, *, heads: int, kv_heads: int, head_dim: int, device="cuda") -> Gemma2Encoder:
    """The port's Gemma-2 encoder from the JAX ``Gemma2Encoder.named_parameters()``
    (``layers.{i}.*``, ``embed``, ``final_norm``), with the soft-cap 50 and
    the query scale head_dim^-0.5 of the JAX ``random_init`` (and of
    gemma-2-2b)."""
    P = _Params(params, device)
    layers = 1 + max(int(n.split(".")[1]) for n in params if n.startswith("layers."))
    lys = []
    for i in range(layers):
        p = f"layers.{i}."
        lys.append(Gemma2Layer(
            P.get(p + "in_norm"), *[P.linear(p + n) for n in "qkvo"], P.get(p + "post_attn_norm"),
            P.get(p + "pre_ff_norm"), *[P.linear(p + n) for n in ("gate", "up", "down")], P.get(p + "post_ff_norm"),
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, softcap=50.0, query_scale=head_dim ** -0.5))
    model = Gemma2Encoder(P.get("embed"), lys, P.get("final_norm"))
    P.done()
    return model
