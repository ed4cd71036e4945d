"""Load nunchaku FLUX checkpoints into the port's model.

Counterpart of ``nunchaku_tpu/models/transformers/loader.py``: reads the
reference's single-file safetensors format (v1 key schema from the C++
module registry, FluxModel.cpp:1239-1261 + csrc naming; metadata keys
``config`` / ``quantization_config``), decodes the CUDA MMA-swizzled tensors
(``utils/nunchaku_format.py``) and repacks them into the port's layouts. The
AdaLN +1 scale shift is pre-folded in these checkpoints (FluxModel.cpp:91
applies offset 0.0), so the loaded model's attention-branch norms take
``scale_shift = 0``.

``precision`` converts at load: ``"int8"`` requantizes the dequantized 4-bit
residual weights to per-channel int8, ``"w4a8"`` keeps the packed codes with
a per-channel int8 scale and per-group rescales (an nvfp4 checkpoint keeps
its e2m1 codes: nvfp4-a8), and both requantize the AWQ modulation linears to
int8 SVDQ linears. The arithmetic is the JAX loader's numpy arithmetic, bit
for bit: true f32 divisions (``absmax / 127.0``, ``w / scale``; a divisor is
given as a tensor, since PyTorch's CUDA division by a host scalar multiplies
by its reciprocal), round half to even. One deviation: the JAX loader's
table decode turns the stray e2m1 code -8 into NaN at int8; the port decodes
it to -8, as the dequant kernel and the JAX package's other decoders do.

The blocks are stacked, as the JAX loader stacks them: each block is
decoded and copied into its stack in turn (``linear.build_stacked``), so the
model is never held twice. Tensors are decoded on ``device`` (the card
unless the caller asks for the CPU); the file is read through mmap.
"""

from __future__ import annotations

import json

import torch

from ..core.packing import pack_int4
from ..ops.reference import decode_e2m1
from ..utils import nunchaku_format as NF
from ..utils.safetensors import SafeTensors
from .attention import FeedForward, FluxAttention
from .embeddings import CombinedTimestepEmbeddings, MLPEmbedder
from .linear import AWQW4A16Linear, Linear, SVDQW4A4Linear, build_stacked
from .normalization import AdaLayerNormContinuous, AdaLayerNormZero, AdaLayerNormZeroSingle
from .transformer_flux import FluxConfig, FluxSingleTransformerBlock, FluxTransformer2DModel, FluxTransformerBlock

OUT_PRECISIONS = (None, "int4", "nvfp4", "int8", "w4a8")


class _Reader:
    """Tensors of one key prefix, moved to ``device`` as read."""

    def __init__(self, st: SafeTensors, prefix: str = "", device="cuda"):
        self.st, self.prefix, self.device = st, prefix, device

    def sub(self, name):
        return _Reader(self.st, f"{self.prefix}{name}.", self.device)

    def __call__(self, name) -> torch.Tensor:
        return self.st.tensor(self.prefix + name).to(self.device)

    def f32(self, name) -> torch.Tensor:
        return self(name).float()

    def bf16(self, name) -> torch.Tensor:
        return self(name).float().to(torch.bfloat16)

    def has(self, name):
        return (self.prefix + name) in self.st


def _fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true f32 division on every device (numpy's ``x / d``)."""
    return x / torch.full_like(x, d)


def _int8_rows(w_deq: torch.Tensor):
    """(K, N) f32 -> per-channel int8 codes and (1, N) f32 scales, as the
    JAX loaders round: scale = absmax / 127 (1 where absmax is 0), codes
    clip(round(w / scale), -127, 127)."""
    absmax = w_deq.abs().amax(dim=0)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), _fdiv(absmax, 127.0))
    q8 = torch.round(w_deq / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return q8, scale.reshape(1, -1)


def _e4m3(bytes_: torch.Tensor) -> torch.Tensor:
    return bytes_.view(torch.float8_e4m3fn).float()


def svdq_weight_scales(r: _Reader, precision: str):
    """The checkpoint's signed codes (N, K) int8 and (K/G, N) f32 group
    scales (nvfp4: the e4m3 micro-scales times ``wtscale`` and the per-
    channel ``wcscales``, as the JAX decoders fold them)."""
    qw_packed = r("qweight")
    n, k = qw_packed.shape[0], qw_packed.shape[1] * 2
    vals = NF.unpack_weight_int4(qw_packed, n, k)
    if precision == "nvfp4":
        ws = _e4m3(NF.unpack_micro_scale(r("wscales").view(torch.uint8), n))
        if r.has("wtscale"):
            ws = ws * float(r.f32("wtscale"))
        if r.has("wcscales"):
            ws = ws * _e4m3(NF.unpack_scale(r("wcscales").view(torch.uint8), n)).reshape(1, n)
    else:
        ws = NF.unpack_scale(r.f32("wscales"), n)
    return vals, ws


def make_svdq(vals, ws, smooth, pd, pu, bias, *, precision: str, out_precision: str) -> SVDQW4A4Linear:
    """An SVDQW4A4Linear at ``out_precision`` from a checkpoint's decoded
    codes (N, K), group scales (K/G, N) f32, smooth (K,), proj_down (K, R),
    proj_up (R, N) and bias (N,) or None (JAX ``_decode_svdq`` :89-139)."""
    n, k = vals.shape
    common = dict(smooth=smooth.to(torch.bfloat16), proj_down=pd.to(torch.bfloat16),
                  proj_up=pu.to(torch.bfloat16), bias=None if bias is None else bias.to(torch.bfloat16))
    if out_precision == "int8":
        v = decode_e2m1(vals) if precision == "nvfp4" else vals.float()
        g = k // ws.shape[0]
        w_deq = (v.t().reshape(k // g, g, n) * ws[:, None, :]).reshape(k, n)
        q8, scale = _int8_rows(w_deq)
        return SVDQW4A4Linear(q8, scale, precision="int8", **common)
    packed = pack_int4(vals.t(), 0)
    if out_precision == "w4a8":
        # packed codes + per-channel int8 scale + per-group rescales; nvfp4
        # keeps its e2m1 codes (their largest value 6, int4's 7)
        cmax = 6.0 if precision == "nvfp4" else 7.0
        s8 = _fdiv(ws.amax(dim=0) * cmax, 127.0).clamp_min(1e-12)
        rs = ws / s8[None, :]
        return SVDQW4A4Linear(packed, s8.reshape(1, n), rescales=rs.to(torch.bfloat16), precision="w4a8",
                              wcodes="e2m1" if precision == "nvfp4" else "int4", **common)
    return SVDQW4A4Linear(packed, ws.to(torch.bfloat16), precision=precision, **common)


def _decode_svdq(r: _Reader, *, precision: str, out_precision: str) -> SVDQW4A4Linear:
    """One GEMM_W4A4 module (v1 schema: MMA-packed ``lora_down`` /
    ``lora_up``) -> an SVDQW4A4Linear."""
    vals, ws = svdq_weight_scales(r, precision)
    pd = NF.unpack_lowrank_weight(r.f32("lora_down"), down=True).t()  # (K, R)
    pu = NF.unpack_lowrank_weight(r.f32("lora_up"), down=False).t()  # (R, N)
    bias = r.f32("bias") if r.has("bias") else None
    return make_svdq(vals, ws, r.f32("smooth"), pd, pu, bias, precision=precision, out_precision=out_precision)


def _mod_perm(d: int, parts: int, device=None) -> torch.Tensor:
    """Column permutation: interleaved [c*parts + p] -> part-major [p*d + c]
    (the checkpoint's AdaLN linear emits part-interleaved columns; the
    port's norms split contiguous chunks)."""
    return (torch.arange(d, device=device)[None, :] * parts + torch.arange(parts, device=device)[:, None]).reshape(-1)


def _decode_awq(r: _Reader, parts: int | None = None, out_precision: str = "int4"):
    """A GEMV_AWQ module (AdaLN modulation linear). At int8 / w4a8 the
    dequantized weight is requantized to a per-channel int8 SVDQ linear
    with a zero rank-16 branch (JAX :157-206)."""
    qw = r("qweight")
    oc4, icp = qw.shape
    oc, ic = oc4 * 4, icp // 4 * 8
    codes = NF.unpack_awq_gemv(qw, oc, ic)  # (N, K) unsigned
    ws = r.f32("wscales")  # (K/G, N) plain
    wz = -r.f32("wzeros")  # stored scaled-negated; here w = q*s - z
    bias = r.f32("bias") if r.has("bias") else None
    if parts:  # interleaved modulation chunks -> contiguous
        perm = _mod_perm(oc // parts, parts, codes.device)
        codes, ws, wz = codes[perm], ws[:, perm], wz[:, perm]
        bias = None if bias is None else bias[perm]
    if out_precision in ("int8", "w4a8"):
        g = ic // ws.shape[0]
        w_deq = codes.t().float() * ws.repeat_interleave(g, dim=0) - wz.repeat_interleave(g, dim=0)
        q8, scale = _int8_rows(w_deq)
        dev = q8.device
        return SVDQW4A4Linear(q8, scale, torch.ones((ic,), dtype=torch.bfloat16, device=dev),
                              torch.zeros((ic, 16), dtype=torch.bfloat16, device=dev),
                              torch.zeros((16, oc), dtype=torch.bfloat16, device=dev),
                              None if bias is None else bias.to(torch.bfloat16), precision="int8")
    return AWQW4A16Linear(pack_int4(codes.t(), 0), ws.to(torch.bfloat16), wz.to(torch.bfloat16),
                          None if bias is None else bias.to(torch.bfloat16))


def _decode_linear(r: _Reader, name: str) -> Linear:
    w = r.f32(f"{name}.weight").t().contiguous()  # torch (out, in) -> (in, out)
    return Linear(w.to(torch.bfloat16), r.bf16(f"{name}.bias") if r.has(f"{name}.bias") else None)


def checkpoint_precision(qcfg: dict) -> str:
    return "nvfp4" if "fp4" in str(qcfg.get("weight", {})) else "int4"


def _check_precision(precision):
    if precision not in OUT_PRECISIONS:
        raise ValueError(f"precision must be one of {OUT_PRECISIONS}, got {precision!r}")


@torch.no_grad()
def load_flux_transformer(path, precision: str | None = None, device="cuda") -> FluxTransformer2DModel:
    """A FluxTransformer2DModel from a nunchaku single-file checkpoint.

    ``precision``: None keeps the checkpoint's own int4 / nvfp4; ``"int8"``
    and ``"w4a8"`` convert at load (``"w4a8"`` from nvfp4 is nvfp4-a8).
    ``device``: where the weights are decoded and kept."""
    _check_precision(precision)
    st = SafeTensors(path)
    config = json.loads(st.metadata.get("config", "{}"))
    qcfg = json.loads(st.metadata.get("quantization_config", "{}"))
    ckpt_precision = checkpoint_precision(qcfg)
    out_precision = precision or ckpt_precision
    if out_precision in ("int4", "nvfp4") and out_precision != ckpt_precision:
        raise ValueError(f"a {ckpt_precision} checkpoint loads at {ckpt_precision}, int8 or w4a8, not {out_precision}")
    cfg = FluxConfig(
        num_layers=config.get("num_layers", 19),
        num_single_layers=config.get("num_single_layers", 38),
        attention_head_dim=config.get("attention_head_dim", 128),
        num_attention_heads=config.get("num_attention_heads", 24),
        joint_attention_dim=config.get("joint_attention_dim", 4096),
        pooled_projection_dim=config.get("pooled_projection_dim", 768),
        in_channels=config.get("in_channels", 64),
        out_channels=config.get("out_channels", 64) or 64,
        guidance_embeds=config.get("guidance_embeds", True),
        axes_dims_rope=tuple(config.get("axes_dims_rope", (16, 56, 56))),
        rank=qcfg.get("rank", 32),
        precision=out_precision,
    )
    root = _Reader(st, "", device)
    kw = dict(precision=ckpt_precision, out_precision=out_precision)
    # int4 checkpoints fold the post-GELU shift's compensation into fc2's
    # bias, so fc2 takes shifted activations at every out-precision (JAX :290-291)
    unsigned = ckpt_precision == "int4"

    def svdq(prefix, act_unsigned=False):
        lin = _decode_svdq(root.sub(prefix), **kw)
        lin.act_unsigned = act_unsigned
        return lin

    def ff(p, fc1, fc2):
        return FeedForward(svdq(f"{p}.{fc1}"), svdq(f"{p}.{fc2}", unsigned))

    def awq(b, name, parts):
        return _decode_awq(b.sub(name), parts=parts, out_precision=out_precision)

    def dual(i):
        p = f"transformer_blocks.{i}"
        b = root.sub(p)
        attn = FluxAttention(
            svdq(f"{p}.qkv_proj"), b.bf16("norm_q.weight"), b.bf16("norm_k.weight"),
            to_out=svdq(f"{p}.out_proj"), add_qkv_proj=svdq(f"{p}.qkv_proj_context"),
            norm_added_q=b.bf16("norm_added_q.weight"), norm_added_k=b.bf16("norm_added_k.weight"),
            to_add_out=svdq(f"{p}.out_proj_context"), head_dim=cfg.attention_head_dim)
        return FluxTransformerBlock(
            AdaLayerNormZero(awq(b, "norm1.linear", 6), scale_shift=0.0),
            AdaLayerNormZero(awq(b, "norm1_context.linear", 6), scale_shift=0.0),
            attn, ff(p, "mlp_fc1", "mlp_fc2"), ff(p, "mlp_context_fc1", "mlp_context_fc2"))

    def single(i):
        p = f"single_transformer_blocks.{i}"
        b = root.sub(p)
        attn = FluxAttention(svdq(f"{p}.qkv_proj"), b.bf16("norm_q.weight"), b.bf16("norm_k.weight"),
                             head_dim=cfg.attention_head_dim)
        return FluxSingleTransformerBlock(
            AdaLayerNormZeroSingle(awq(b, "norm.linear", 3), scale_shift=0.0), attn,
            svdq(f"{p}.mlp_fc1"), svdq(f"{p}.mlp_fc2", unsigned), svdq(f"{p}.out_proj"))

    # each block is decoded and copied into its stack in turn
    dual_stack = build_stacked(dual, cfg.num_layers)
    single_stack = build_stacked(single, cfg.num_single_layers)

    te = "time_text_embed"

    def mlp_embedder(name):
        return MLPEmbedder(_decode_linear(root, f"{te}.{name}.linear_1"), _decode_linear(root, f"{te}.{name}.linear_2"))

    guidance = (mlp_embedder("guidance_embedder") if root.has(f"{te}.guidance_embedder.linear_1.weight") else None)
    return FluxTransformer2DModel(
        cfg, _decode_linear(root, "x_embedder"), _decode_linear(root, "context_embedder"),
        CombinedTimestepEmbeddings(mlp_embedder("timestep_embedder"), mlp_embedder("text_embedder"), guidance),
        dual_stack, single_stack, AdaLayerNormContinuous(_decode_linear(root, "norm_out.linear")),
        _decode_linear(root, "proj_out"))
