"""T5 encoder (FLUX's ``text_encoder_2``) with bf16 or AWQ W4A16 linears.

Counterpart of ``nunchaku_tpu/models/text_encoders/t5.py`` (:28-162):
pre-RMSNorm blocks, a relative position bias that block 0 holds and every
block adds, unscaled f32 attention scores, a gated tanh-GELU feed-forward,
no biases. The AWQ linears run at M = B * S >= 16, so they take the
dequantize-then-multiply route (``ops/gemv.py``), as in JAX. The residual
stream is f32; every linear takes bf16 inputs. ``load_t5_encoder`` reads
the reference's TinyChat W4 file and plain bf16 HF files.
"""

from __future__ import annotations

import json
import math

import torch
from torch import nn

from ...ops.reference import gelu_jax, rmsnorm
from ..linear import AWQW4A16Linear, Linear

NUM_BUCKETS, MAX_DISTANCE = 32, 128


def t5_relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = NUM_BUCKETS,
                                max_distance: int = MAX_DISTANCE) -> torch.Tensor:
    """Bidirectional T5 bucket of each relative position (key - query), in
    the f32 arithmetic of the JAX function."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    large = (torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
             * (num_buckets - max_exact))
    val_large = torch.clamp(max_exact + large.to(torch.int32), max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, q, k, v, o, *, heads, d_kv, rel_bias=None):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o
        self.heads, self.d_kv = heads, d_kv
        self.register_buffer("rel_bias", rel_bias)  # (num_buckets, heads) f32, block 0 only

    def forward(self, x, pos_bias):
        b, s, _ = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        scores = q.float() @ k.float().transpose(-1, -2) + pos_bias  # T5 does not scale by sqrt(d)
        attn = torch.softmax(scores, dim=-1).to(torch.bfloat16)
        o = (attn.float() @ v.to(torch.bfloat16).float()).to(torch.bfloat16)
        return self.o(o.transpose(1, 2).reshape(b, s, self.heads * self.d_kv))


class T5FF(nn.Module):
    def __init__(self, wi_0, wi_1, wo):
        super().__init__()
        self.wi_0, self.wi_1, self.wo = wi_0, wi_1, wo

    def forward(self, x):
        h = gelu_jax(self.wi_0(x).float()) * self.wi_1(x).float()
        return self.wo(h.to(torch.bfloat16))


class T5Block(nn.Module):
    def __init__(self, ln1, attn, ln2, ff):
        super().__init__()
        self.register_buffer("ln1", ln1)  # RMSNorm weights (d_model,) bf16
        self.register_buffer("ln2", ln2)
        self.attn, self.ff = attn, ff

    def forward(self, x, pos_bias):
        x = x + self.attn(rmsnorm(x, self.ln1).to(torch.bfloat16), pos_bias).float()
        return x + self.ff(rmsnorm(x, self.ln2).to(torch.bfloat16)).float()


class T5EncoderModel(nn.Module):
    def __init__(self, embed_tokens, blocks, final_norm, *, heads, d_kv):
        super().__init__()
        self.register_buffer("embed_tokens", embed_tokens)  # (vocab, d_model) bf16
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("final_norm", final_norm)
        self.heads, self.d_kv = heads, d_kv

    @classmethod
    def random_init(cls, *, vocab=32128, d_model=512, d_ff=1024, d_kv=64, heads=8, layers=2, quantized=False,
                    seed=0, device="cuda"):
        """The distributions of the JAX ``random_init`` (t5.py:106-127), made
        on ``device`` from ``seed``; ``quantized``: AWQ W4A16 linears."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        lin_cls = AWQW4A16Linear if quantized else Linear

        def mk(i, o):
            return lin_cls.random_init(gen, i, o, bias=False, device=device)

        def ones():
            return torch.ones((d_model,), dtype=torch.bfloat16, device=device)

        inner = heads * d_kv
        blocks = []
        for li in range(layers):
            rel = torch.randn((NUM_BUCKETS, heads), generator=gen, device=device) * 0.02 if li == 0 else None
            attn = T5Attention(mk(d_model, inner), mk(d_model, inner), mk(d_model, inner), mk(inner, d_model),
                               heads=heads, d_kv=d_kv, rel_bias=rel)
            blocks.append(T5Block(ones(), attn, ones(), T5FF(mk(d_model, d_ff), mk(d_model, d_ff), mk(d_ff, d_model))))
        emb = torch.randn((vocab, d_model), generator=gen, device=device).to(torch.bfloat16)
        return cls(emb, blocks, ones(), heads=heads, d_kv=d_kv)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> (B, S, d_model) bf16 final hidden states."""
        s = input_ids.shape[1]
        x = self.embed_tokens[input_ids].float()
        pos = torch.arange(s, device=input_ids.device)
        buckets = t5_relative_position_bucket(pos[None, :] - pos[:, None])
        pos_bias = self.blocks[0].attn.rel_bias.float()[buckets].permute(2, 0, 1)[None]  # (1, H, S, S)
        for blk in self.blocks:
            x = blk(x, pos_bias)
        return rmsnorm(x, self.final_norm).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


@torch.no_grad()
def load_t5_encoder(path_or_tensors, config: dict | None = None, device="cuda") -> T5EncoderModel:
    """A T5 encoder from HF-format tensors (a file or a dict of tensors),
    4-bit where a ``qweight`` exists (JAX ``load_t5_encoder``, t5.py:165).

    Takes the reference's quantized T5 single file (TinyChat W4 tensors
    ``*.qweight`` (oc/4, ic) int16, ``wscales`` / ``wzeros`` (ic/G, oc), the
    zeros stored negated; the group G comes from the scales) and plain bf16
    HF files. ``config`` defaults to the file's ``config`` metadata."""
    from ...core.packing import pack_int4
    from ...utils import nunchaku_format as NF
    from ...utils.safetensors import load_safetensors

    if isinstance(path_or_tensors, dict):
        sd, meta = path_or_tensors, {}
    else:
        sd, meta = load_safetensors(path_or_tensors)
    if config is None:
        config = json.loads(meta.get("config", "{}"))
    heads = config.get("num_heads", 64)
    d_kv = config.get("d_kv", 64)
    layers = config.get("num_layers", 24)

    def get(name):
        return sd[name].to(device)

    def bf16(name):
        return get(name).float().to(torch.bfloat16)

    def lin(prefix):
        if f"{prefix}.qweight" in sd:
            qw = get(f"{prefix}.qweight")
            ws, wz = get(f"{prefix}.wscales").float(), get(f"{prefix}.wzeros").float()
            oc, ic = qw.shape[0] * 4, qw.shape[1]
            codes = NF.unpack_tinychat_w4(qw, oc, ic)  # (oc, ic) unsigned
            return AWQW4A16Linear(pack_int4(codes.t(), 0), ws.to(torch.bfloat16), (-wz).to(torch.bfloat16), None)
        return Linear(get(f"{prefix}.weight").float().t().contiguous().to(torch.bfloat16), None)

    blocks = []
    for i in range(layers):
        p = f"encoder.block.{i}"
        a, f = f"{p}.layer.0.SelfAttention", f"{p}.layer.1.DenseReluDense"
        rel = get(f"{a}.relative_attention_bias.weight").float() if i == 0 else None
        attn = T5Attention(lin(f"{a}.q"), lin(f"{a}.k"), lin(f"{a}.v"), lin(f"{a}.o"), heads=heads, d_kv=d_kv,
                           rel_bias=rel)
        blocks.append(T5Block(bf16(f"{p}.layer.0.layer_norm.weight"), attn, bf16(f"{p}.layer.1.layer_norm.weight"),
                              T5FF(lin(f"{f}.wi_0"), lin(f"{f}.wi_1"), lin(f"{f}.wo"))))
    return T5EncoderModel(bf16("shared.weight"), blocks, bf16("encoder.final_layer_norm.weight"), heads=heads,
                          d_kv=d_kv)
