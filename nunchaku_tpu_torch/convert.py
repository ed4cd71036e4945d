"""Carry FLUX and VAE weights from the JAX package into the port.

``flux_from_jax_params`` takes the dotted names of the JAX
``Module.named_parameters()`` (``nunchaku_tpu/core/module.py``) mapped to
numpy arrays -- the blocks' leaves carry a leading layer axis -- and builds
the port's per-layer modules from them. Static attributes (precision, the
int4 fc2 layers' unsigned activations, head dim) come from the config, and
every linear's shape is checked against the config's dims.
``vae_from_jax_params`` does the same for the VAE decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.attention import FeedForward, FluxAttention
from .models.autoencoder import AttnBlock, AutoencoderKL, Conv2d, Decoder, ResnetBlock, Upsample
from .models.embeddings import CombinedTimestepEmbeddings, MLPEmbedder
from .models.linear import AWQW4A16Linear, Linear, SVDQW4A4Linear
from .models.normalization import AdaLayerNormContinuous, AdaLayerNormZero, AdaLayerNormZeroSingle
from .models.transformer_flux import (
    FluxConfig,
    FluxSingleTransformerBlock,
    FluxTransformer2DModel,
    FluxTransformerBlock,
)
from .ops.reference import is_4bit


def to_torch(a, device="cuda") -> torch.Tensor:
    """numpy array (bf16 as ml_dtypes / JAX stores it) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def flux_from_jax_params(params: dict, cfg: FluxConfig, device="cuda") -> FluxTransformer2DModel:
    used = set()

    def get(name, layer=None):
        used.add(name)
        a = np.asarray(params[name])
        return to_torch(a if layer is None else a[layer], device)

    def opt(name, layer=None):
        return get(name, layer) if name in params else None

    def linear(prefix):
        return Linear(get(prefix + ".weight"), opt(prefix + ".bias"))

    def check(prefix, lin, k, n):
        if (lin.in_features, lin.out_features) != (k, n):
            raise ValueError(f"{prefix}: ({lin.in_features}, {lin.out_features}) does not match "
                             f"the config's ({k}, {n})")
        return lin

    def svdq(prefix, layer, precision, k, n, act_unsigned=False):
        return check(prefix, SVDQW4A4Linear(
            get(prefix + ".qweight", layer), get(prefix + ".wscales", layer),
            get(prefix + ".smooth", layer), get(prefix + ".proj_down", layer),
            get(prefix + ".proj_up", layer), opt(prefix + ".bias", layer),
            opt(prefix + ".rescales", layer), precision=precision, act_unsigned=act_unsigned), k, n)

    p = cfg.precision
    if p not in ("int8", "w4a8", "int4", "nvfp4"):
        raise NotImplementedError(f"precision {p!r} is not ported")
    dim = cfg.dim
    unsigned_fc2 = p == "int4"  # the post-GELU layers of an int4 model take unsigned activations

    def mod(prefix, layer, n):
        """The modulation linear: AWQ at int4 / nvfp4, int8 SVDQ otherwise."""
        if is_4bit(p):
            return check(prefix, AWQW4A16Linear(
                get(prefix + ".qweight", layer), get(prefix + ".wscales", layer),
                get(prefix + ".wzeros", layer), opt(prefix + ".bias", layer)), dim, n)
        return svdq(prefix, layer, "int8", dim, n)

    def attn(prefix, layer, joint):
        kw = dict(head_dim=cfg.attention_head_dim)
        qkv = svdq(prefix + ".to_qkv", layer, p, dim, 3 * dim)
        nq, nk = get(prefix + ".norm_q", layer), get(prefix + ".norm_k", layer)
        if not joint:
            return FluxAttention(qkv, nq, nk, **kw)
        return FluxAttention(
            qkv, nq, nk, to_out=svdq(prefix + ".to_out", layer, p, dim, dim),
            add_qkv_proj=svdq(prefix + ".add_qkv_proj", layer, p, dim, 3 * dim),
            norm_added_q=get(prefix + ".norm_added_q", layer),
            norm_added_k=get(prefix + ".norm_added_k", layer),
            to_add_out=svdq(prefix + ".to_add_out", layer, p, dim, dim), **kw)

    def ff(prefix, layer):
        return FeedForward(svdq(prefix + ".fc1", layer, p, dim, 4 * dim),
                           svdq(prefix + ".fc2", layer, p, 4 * dim, dim, unsigned_fc2))

    dual = []
    for i in range(cfg.num_layers):
        t = "transformer_blocks"
        dual.append(FluxTransformerBlock(
            AdaLayerNormZero(mod(t + ".norm1.linear", i, 6 * dim)),
            AdaLayerNormZero(mod(t + ".norm1_context.linear", i, 6 * dim)),
            attn(t + ".attn", i, True), ff(t + ".ff", i), ff(t + ".ff_context", i)))
    single = []
    for i in range(cfg.num_single_layers):
        t = "single_transformer_blocks"
        single.append(FluxSingleTransformerBlock(
            AdaLayerNormZeroSingle(mod(t + ".norm.linear", i, 3 * dim)),
            attn(t + ".attn", i, False),
            svdq(t + ".mlp_fc1", i, p, dim, 4 * dim), svdq(t + ".mlp_fc2", i, p, 4 * dim, dim, unsigned_fc2),
            svdq(t + ".attn_out", i, p, dim, dim)))
    te = "time_text_embed"
    guidance = None
    if cfg.guidance_embeds:
        guidance = MLPEmbedder(linear(te + ".guidance_embedder.fc1"), linear(te + ".guidance_embedder.fc2"))
    model = FluxTransformer2DModel(
        cfg, linear("x_embedder"), linear("context_embedder"),
        CombinedTimestepEmbeddings(
            MLPEmbedder(linear(te + ".timestep_embedder.fc1"), linear(te + ".timestep_embedder.fc2")),
            MLPEmbedder(linear(te + ".text_embedder.fc1"), linear(te + ".text_embedder.fc2")),
            guidance),
        dual, single, AdaLayerNormContinuous(linear("norm_out.linear")), linear("proj_out"))
    unused = sorted(set(params) - used)
    if unused:
        raise KeyError(f"parameters the port does not take: {unused[:8]}")
    return model


def vae_from_jax_params(params: dict, *, latent_channels=16, block_out_channels=(128, 256, 512, 512),
                        layers_per_block=2, scaling_factor=0.3611, shift_factor=0.1159,
                        device="cuda") -> AutoencoderKL:
    """The port's decoder from the JAX ``AutoencoderKL.named_parameters()``,
    every shape checked against the given structure. The JAX encoder's
    ``encoder.*`` leaves are skipped (the port has no encoder yet); any
    other name the decoder does not take raises."""
    used = set()

    def get(name, shape):
        used.add(name)
        a = np.asarray(params[name])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not match the structure's {tuple(shape)}")
        return to_torch(a, device)

    def conv(prefix, cin, cout, k=3):
        return Conv2d(get(prefix + ".weight", (cout, cin, k, k)), get(prefix + ".bias", (cout,)), 1,
                      1 if k == 3 else 0)

    def vec(name, c):
        return get(name, (c,))

    def resnet(prefix, cin, cout):
        sc = conv(prefix + ".shortcut", cin, cout, k=1) if cin != cout else None
        return ResnetBlock(vec(prefix + ".norm1_w", cin), vec(prefix + ".norm1_b", cin),
                           conv(prefix + ".conv1", cin, cout), vec(prefix + ".norm2_w", cout),
                           vec(prefix + ".norm2_b", cout), conv(prefix + ".conv2", cout, cout), sc)

    d = "decoder"
    ch = block_out_channels[-1]
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
    a = d + ".mid_attn"
    decoder = Decoder(
        conv(d + ".conv_in", latent_channels, ch), resnet(d + ".mid_r1", ch, ch),
        AttnBlock(vec(a + ".norm_w", ch), vec(a + ".norm_b", ch),
                  *[conv(f"{a}.{n}", ch, ch, k=1) for n in ("q", "k", "v", "out")]),
        resnet(d + ".mid_r2", ch, ch), up_blocks, upsamplers,
        vec(d + ".norm_out_w", block_out_channels[0]), vec(d + ".norm_out_b", block_out_channels[0]),
        conv(d + ".conv_out", block_out_channels[0], 3))
    unused = sorted(n for n in set(params) - used if not n.startswith("encoder."))
    if unused:
        raise KeyError(f"parameters the port does not take: {unused[:8]}")
    return AutoencoderKL(scaling_factor=scaling_factor, shift_factor=shift_factor, decoder=decoder)
