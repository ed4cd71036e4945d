"""Gemma-2 text encoder (SANA's caption encoder), bf16.

Counterpart of ``nunchaku_tpu/models/text_encoders/gemma2.py``: ``Gemma2Layer``
(:48), ``Gemma2Encoder`` (:96, ``_gemma2_encode`` :122) and
``load_gemma2_encoder`` (:146). SANA conditions on the last hidden states
of google/gemma-2-2b-it (d 2304). A decoder-only transformer used as an
encoder: causal mask, grouped-query attention (8 query heads over 4 kv heads
of 256), half-split RoPE (theta 10000), the attention logits soft-capped as
``tanh(s / 50) * 50``, four RMSNorms a layer with the (1 + w) convention,
a GeGLU MLP (tanh GELU), embeddings scaled by sqrt(d). The residual stream
is f32, the linears bf16 with f32 accumulation. The attention is torch ops
in f32, as JAX computes it with einsums (a fused attention could not
soft-cap its logits). As in JAX, the 4096-token sliding window of
alternating layers is not modelled (it never binds at SANA's 300 tokens).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops.reference import gelu_jax
from ..linear import Linear

GEMMA2_2B = dict(vocab=256000, d=2304, heads=8, kv_heads=4, head_dim=256, inter=9216, layers=26)
RMS_EPS = 1e-6
ROPE_THETA = 10000.0


def _rms(x, w, eps=RMS_EPS):
    """f32 RMSNorm times (1 + w)."""
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps) * (1.0 + w.float())


def _rope_tables(s: int, d: int, device):
    """Half-split cos / sin (S, D) f32, the angles in f64 (numpy) as in JAX."""
    inv = 1.0 / (ROPE_THETA ** (np.arange(0, d, 2, dtype=np.float64) / d))
    f = np.einsum("s,f->sf", np.arange(s, dtype=np.float64), inv)
    cos = torch.from_numpy(np.cos(f).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(f).astype(np.float32)).to(device)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def _rope(x, cos, sin):
    """(B, H, S, D) half-split rope, result in x's dtype."""
    xf = x.float()
    d = xf.shape[-1]
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


class Gemma2Layer(nn.Module):
    def __init__(self, in_norm, q, k, v, o, post_attn_norm, pre_ff_norm, gate, up, down, post_ff_norm, *, heads,
                 kv_heads, head_dim, softcap, query_scale):
        super().__init__()
        for name, t in (("in_norm", in_norm), ("post_attn_norm", post_attn_norm), ("pre_ff_norm", pre_ff_norm),
                        ("post_ff_norm", post_ff_norm)):
            self.register_buffer(name, t)
        self.q, self.k, self.v, self.o = q, k, v, o
        self.gate, self.up, self.down = gate, up, down
        self.heads = heads
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.softcap = softcap
        self.query_scale = query_scale

    def forward(self, x, mask, cos, sin):
        """x (B, S, d) f32 stream, mask (B or 1, 1, S, S) additive f32."""
        b, s, _ = x.shape
        y = _rms(x, self.in_norm).to(torch.bfloat16)

        def split(t, h):
            return t.reshape(b, s, h, self.head_dim).transpose(1, 2)

        q = _rope(split(self.q(y), self.heads), cos, sin)
        k = _rope(split(self.k(y), self.kv_heads), cos, sin)
        v = split(self.v(y), self.kv_heads)
        rep = self.heads // self.kv_heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        scores = (q.float() @ k.float().transpose(-1, -2)) * self.query_scale
        if self.softcap:
            scores = torch.tanh(scores / self.softcap) * self.softcap
        attn = torch.softmax(scores + mask, dim=-1).to(torch.bfloat16)
        o = (attn.float() @ v.to(torch.bfloat16).float()).to(torch.bfloat16)
        o = self.o(o.transpose(1, 2).reshape(b, s, -1)).float()
        x = x + _rms(o, self.post_attn_norm)
        y = _rms(x, self.pre_ff_norm).to(torch.bfloat16)
        h = (gelu_jax(self.gate(y).float()) * self.up(y).float()).to(torch.bfloat16)
        return x + _rms(self.down(h).float(), self.post_ff_norm)


class Gemma2Encoder(nn.Module):
    def __init__(self, embed, layers, final_norm):
        super().__init__()
        self.register_buffer("embed", embed)  # (vocab, d) bf16
        self.layers = nn.ModuleList(layers)
        self.register_buffer("final_norm", final_norm)

    @classmethod
    def random_init(cls, *, vocab=256, d=64, heads=4, kv_heads=2, head_dim=16, inter=128, layers=2, seed=0,
                    device="cuda"):
        """The distributions of the JAX ``random_init`` (:105-120: weights
        N(0, 0.02), norms 0, i.e. gains of 1), made on ``device`` from
        ``seed``; ``**GEMMA2_2B`` gives gemma-2-2b's shapes."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def mk(i, o):
            return Linear((torch.randn((i, o), generator=gen, device=device) * 0.02).to(torch.bfloat16))

        def z(n=d):
            return torch.zeros((n,), dtype=torch.bfloat16, device=device)

        lys = [Gemma2Layer(z(), mk(d, heads * head_dim), mk(d, kv_heads * head_dim), mk(d, kv_heads * head_dim),
                           mk(heads * head_dim, d), z(), z(), mk(d, inter), mk(d, inter), mk(inter, d), z(),
                           heads=heads, kv_heads=kv_heads, head_dim=head_dim, softcap=50.0,
                           query_scale=head_dim ** -0.5)
               for _ in range(layers)]
        embed = (torch.randn((vocab, d), generator=gen, device=device) * 0.02).to(torch.bfloat16)
        return cls(embed, lys, z())

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, S) token ids [, (B, S) mask, nonzero = attend] -> last hidden
        states (B, S, d) bf16."""
        dev = self.embed.device
        ids = input_ids.to(dev).long()
        b, s = ids.shape
        d = self.embed.shape[-1]
        x = self.embed[ids].float() * math.sqrt(d)
        mask = torch.triu(torch.full((s, s), -1e30, device=dev), diagonal=1)[None, None]
        if attention_mask is not None:
            mask = mask + torch.where(attention_mask.to(dev)[:, None, None, :] > 0, 0.0, -1e30)
        cos, sin = _rope_tables(s, self.layers[0].head_dim, dev)
        for layer in self.layers:
            x = layer(x, mask, cos, sin)
        return _rms(x, self.final_norm).to(torch.bfloat16)


@torch.no_grad()
def load_gemma2_encoder(path_or_tensors, *, config: dict | None = None, device="cuda") -> Gemma2Encoder:
    """A Gemma2Encoder from an HF ``Gemma2Model`` state dict (``model.*`` or
    bare keys; a file or a dict of tensors), bf16 on ``device``."""
    cfg = {"num_layers": 26, "heads": 8, "kv_heads": 4, "head_dim": 256, "softcap": 50.0,
           "query_pre_attn_scalar": 256.0}
    if config:
        cfg.update(config)
    if isinstance(path_or_tensors, dict):
        sd = path_or_tensors
    else:
        from ...utils.safetensors import load_safetensors

        sd, _ = load_safetensors(path_or_tensors)
    sd = {k.removeprefix("model."): v for k, v in sd.items()}

    def t(name):
        a = sd[name]
        return (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))).to(device)

    def lin(prefix):
        return Linear(t(f"{prefix}.weight").float().t().contiguous().to(torch.bfloat16))

    def vec(name):
        return t(name).float().to(torch.bfloat16)

    layers = []
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}"
        layers.append(Gemma2Layer(
            vec(f"{p}.input_layernorm.weight"),
            *[lin(f"{p}.self_attn.{n}_proj") for n in ("q", "k", "v", "o")],
            vec(f"{p}.post_attention_layernorm.weight"), vec(f"{p}.pre_feedforward_layernorm.weight"),
            *[lin(f"{p}.mlp.{n}_proj") for n in ("gate", "up", "down")],
            vec(f"{p}.post_feedforward_layernorm.weight"),
            heads=cfg["heads"], kv_heads=cfg["kv_heads"], head_dim=cfg["head_dim"], softcap=cfg["softcap"],
            query_scale=cfg["query_pre_attn_scalar"] ** -0.5))
    return Gemma2Encoder(vec("embed_tokens.weight"), layers, vec("norm.weight"))
