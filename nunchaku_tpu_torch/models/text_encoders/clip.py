"""CLIP text encoder (FLUX's pooled-embedding encoder).

Counterpart of ``nunchaku_tpu/models/text_encoders/clip.py`` ``CLIPBlock``
and ``CLIPTextModel`` (:18-100, ``_clip_encode`` :176-187): pre-LN blocks
with a causal mask, q scaled by head_dim^-0.5 before the product, a
quick-GELU MLP, a final LayerNorm, and the pooled output taken at the first
``eos_token_id`` of each row. bf16 residual stream, plain bf16 linears.
"""

from __future__ import annotations

import torch
from torch import nn

from ..linear import Linear


def layer_norm_affine(x, w, b, eps=1e-5):
    """LayerNorm in f32 (mean, then the mean of squared deviations, like
    ``jnp.var``) with weight and bias, in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    out = d * torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    return (out * w.float() + b.float()).to(x.dtype)


class CLIPBlock(nn.Module):
    def __init__(self, ln1_w, ln1_b, q, k, v, o, ln2_w, ln2_b, fc1, fc2, *, heads):
        super().__init__()
        for name, t in (("ln1_w", ln1_w), ("ln1_b", ln1_b), ("ln2_w", ln2_w), ("ln2_b", ln2_b)):
            self.register_buffer(name, t)
        self.q, self.k, self.v, self.o, self.fc1, self.fc2 = q, k, v, o, fc1, fc2
        self.heads = heads

    def forward(self, x, mask):
        b, s, d = x.shape
        hd = d // self.heads
        y = layer_norm_affine(x, self.ln1_w, self.ln1_b)

        def split(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        q = split(self.q(y)) * hd ** -0.5
        scores = q.float() @ split(self.k(y)).float().transpose(-1, -2) + mask
        attn = torch.softmax(scores, dim=-1).to(torch.bfloat16)
        o = (attn.float() @ split(self.v(y)).to(torch.bfloat16).float()).to(torch.bfloat16)
        x = x + self.o(o.transpose(1, 2).reshape(b, s, d)).to(x.dtype)
        h = self.fc1(layer_norm_affine(x, self.ln2_w, self.ln2_b)).float()
        h = h * torch.sigmoid(1.702 * h)  # quick-GELU
        return x + self.fc2(h.to(torch.bfloat16)).to(x.dtype)


class CLIPTextModel(nn.Module):
    def __init__(self, token_embedding, position_embedding, blocks, final_ln_w, final_ln_b, *, eos_token_id=2):
        super().__init__()
        for name, t in (("token_embedding", token_embedding), ("position_embedding", position_embedding),
                        ("final_ln_w", final_ln_w), ("final_ln_b", final_ln_b)):
            self.register_buffer(name, t)
        self.blocks = nn.ModuleList(blocks)
        self.eos_token_id = eos_token_id

    @classmethod
    def random_init(cls, *, vocab=1000, d=128, heads=2, layers=2, max_pos=77, seed=0, device="cuda"):
        """The distributions of the JAX ``random_init`` (clip.py:69-85), made
        on ``device`` from ``seed``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def mk(i, o):
            return Linear.random_init(gen, i, o, device=device)

        def ones():
            return torch.ones((d,), dtype=torch.bfloat16, device=device)

        def zeros():
            return torch.zeros((d,), dtype=torch.bfloat16, device=device)

        blocks = [CLIPBlock(ones(), zeros(), mk(d, d), mk(d, d), mk(d, d), mk(d, d), ones(), zeros(),
                            mk(d, 4 * d), mk(4 * d, d), heads=heads) for _ in range(layers)]

        def emb(n):
            return (torch.randn((n, d), generator=gen, device=device) * 0.02).to(torch.bfloat16)

        return cls(emb(vocab), emb(max_pos), blocks, ones(), zeros())

    def forward(self, input_ids: torch.Tensor):
        """(B, S) token ids -> (pooled (B, d), hidden (B, S, d)), bf16."""
        b, s = input_ids.shape
        x = self.token_embedding[input_ids] + self.position_embedding[:s]
        mask = torch.triu(torch.full((s, s), -1e9, device=input_ids.device), diagonal=1)[None, None]
        for blk in self.blocks:
            x = blk(x, mask)
        x = layer_norm_affine(x, self.final_ln_w, self.final_ln_b)
        eos = torch.argmax((input_ids == self.eos_token_id).to(torch.int32), dim=1)
        return x[torch.arange(b, device=x.device), eos], x


@torch.no_grad()
def load_clip_text(path_or_tensors, *, heads=12, layers=12, eos_token_id=2, device="cuda") -> CLIPTextModel:
    """A CLIP text encoder from an HF ``CLIPTextModel`` state dict
    (``text_model.*`` keys; a file or a dict of tensors), bf16 (JAX
    ``load_clip_text``, clip.py:282)."""
    if isinstance(path_or_tensors, dict):
        sd = path_or_tensors
    else:
        from ...utils.safetensors import load_safetensors

        sd, _ = load_safetensors(path_or_tensors)
    sd = {k.removeprefix("text_model."): v for k, v in sd.items()}

    def vec(name):
        return sd[name].to(device).float().to(torch.bfloat16)

    def lin(prefix):
        w = sd[f"{prefix}.weight"].to(device).float().t().contiguous()
        return Linear(w.to(torch.bfloat16), vec(f"{prefix}.bias"))

    blocks = []
    for i in range(layers):
        p = f"encoder.layers.{i}"
        blocks.append(CLIPBlock(
            vec(f"{p}.layer_norm1.weight"), vec(f"{p}.layer_norm1.bias"),
            *[lin(f"{p}.self_attn.{n}_proj") for n in ("q", "k", "v", "out")],
            vec(f"{p}.layer_norm2.weight"), vec(f"{p}.layer_norm2.bias"),
            lin(f"{p}.mlp.fc1"), lin(f"{p}.mlp.fc2"), heads=heads))
    return CLIPTextModel(vec("embeddings.token_embedding.weight"), vec("embeddings.position_embedding.weight"),
                         blocks, vec("final_layer_norm.weight"), vec("final_layer_norm.bias"),
                         eos_token_id=eos_token_id)
