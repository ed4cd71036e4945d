"""Activation quantization with the fused low-rank down-projection.

* :func:`quantize_w4a4_act_fuse_lora` -- ``nunchaku_tpu/ops/quantize.py``
  ``quantize_w4a4_act_fuse_lora`` (:40-131), which JAX leaves to XLA; here it
  is plain PyTorch: the optional GLU product (:56-66, :func:`glu_product`),
  the activation columns zero-padded to the weights' padded K (:68-74), then
  per-token int8 (int8 / w4a8), per-(token, 64-group) int4 with bf16 scales
  (signed, or unsigned after the post-GELU shift), per-(token, 16-group)
  nvfp4 with e4m3 scales and e2m1 codes, round to nearest even; 4-bit codes
  are packed two to a byte.
* :func:`ln_mod_quant_int8` -- kernel ``csrc/ln_mod_quant.cu`` (JAX
  ``_ln_mod_quant_kernel`` :149, ``ln_mod_quant_int8`` :179): LayerNorm,
  AdaLN modulation and the same quantization in one pass over the bf16
  residual stream.
* :func:`ln_mod_quant_int8_dual` -- the dual mode of the same kernel (JAX
  ``_ln_mod_quant2_kernel`` :265, ``ln_mod_quant_int8_dual`` :292): one read
  and one LayerNorm for two quantized activations (FLUX's single block: qkv
  and fc1), each head's outputs those of :func:`ln_mod_quant_int8` with its
  own smooth and ``proj_down``. No model path calls it, as in JAX.

The low-rank activation ``lora_act = bf16(x) @ proj_down`` uses the raw
(or modulated) activation; the quantized codes use ``x / smooth`` (through
a reciprocal), one absmax/127 scale per token, round half to even and clip
to +-127.
"""

from __future__ import annotations

import torch

from ..core.packing import pack_int4
from . import _build
from .reference import (
    E2M1_MAX,
    GELU_SHIFT,
    RCP7,
    RCP15,
    RCP127,
    RCP_E2M1_MAX,
    bf16_matmul,
    e2m1_value_to_code,
    gelu_jax,
    group_size,
    is_4bit,
)

LN_EPS = 1e-6
E4M3_NAN_ABOVE = 464.0  # f32 values above this round past e4m3fn's largest finite value, 448
KERNEL_LN_MAX_K = 3072  # the kernel holds a row in registers: K / 256 <= 12 vectors a lane


def rcp(x: torch.Tensor) -> torch.Tensor:
    """1/x with 0 where x == 0 (the JAX package's guarded reciprocal)."""
    safe = torch.where(x == 0, torch.ones_like(x), x)
    return torch.where(x == 0, torch.zeros_like(x), 1.0 / safe)


def rsmooth_of(smooth: torch.Tensor) -> torch.Tensor:
    """1/smooth in f32, with 1 where smooth == 0."""
    sm = smooth.float()
    safe = torch.where(sm == 0, torch.ones_like(sm), sm)
    return torch.where(sm == 0, torch.ones_like(sm), 1.0 / safe)


def glu_product(x: torch.Tensor, glu_act: str = "silu") -> torch.Tensor:
    """(M, 2K) laid out [value | gate] -> ``value * act(gate)`` in f32,
    rounded to x's dtype (JAX :56-66): ``act`` is silu (SANA, Z-Image) or
    the tanh GELU of ``jax.nn.gelu(approximate=True)`` (SDXL's GEGLU)."""
    if glu_act not in ("silu", "gelu"):
        raise ValueError(f"glu_act {glu_act!r}: silu or gelu")
    k2 = x.shape[-1] // 2
    gate = x[..., k2:].float()
    act = torch.nn.functional.silu(gate) if glu_act == "silu" else gelu_jax(gate)
    return (x[..., :k2].float() * act).to(x.dtype)


def quantize_w4a4_act_fuse_lora(x: torch.Tensor, proj_down: torch.Tensor,
                                smooth: torch.Tensor | None = None, *,
                                precision: str = "int8", act_unsigned: bool = False,
                                fuse_glu: bool = False, glu_act: str = "silu"):
    """(M, K) activations -> (qact, ascales, lora_act (M, R) f32).

    ``fuse_glu``: x is (M, 2K) [value | gate] and the quantized activation
    is :func:`glu_product`. Activations narrower than ``proj_down``'s rows
    (an odd-width layer's padded K) are zero-padded; the padded weight rows
    hold zero codes, so the padded columns add nothing.

    int8 / w4a8: qact (M, K) int8, ascales (1, M) f32 per token. int4 /
    nvfp4: qact (M, K/2) int8 packed along K, ascales (K/G, M) bf16 (G = 64
    / 16). ``act_unsigned`` (int4) adds :data:`GELU_SHIFT` and quantizes to
    [0, 15]. Every divisor is a multiply by the f32 reciprocal, as XLA
    compiles the JAX package's ``absmax / 127.0`` (and ``/ 7``, ``/ 15``,
    ``/ E2M1_MAX``), so codes and scales match it bit for bit."""
    if precision not in ("int8", "w4a8", "int4", "nvfp4"):
        raise NotImplementedError(f"activation quantization for {precision!r} is not ported")
    if fuse_glu:
        x = glu_product(x, glu_act)
    if x.shape[-1] < proj_down.shape[0]:
        x = torch.nn.functional.pad(x, (0, proj_down.shape[0] - x.shape[-1]))
    m, k = x.shape
    lora_act = bf16_matmul(x, proj_down)
    xs = x.float()
    if act_unsigned:
        xs = xs + GELU_SHIFT
    if smooth is not None:
        xs = xs * rsmooth_of(smooth)[None, :]
    if not is_4bit(precision):
        scale = xs.abs().amax(dim=-1) * RCP127
        q = torch.round(xs * rcp(scale)[:, None]).clamp(-127, 127).to(torch.int8)
        return q, scale.reshape(1, m), lora_act
    g = group_size(precision)
    grp = xs.reshape(m, k // g, g)
    absmax = grp.abs().amax(dim=-1)
    if precision == "int4":
        qmax = 15.0 if act_unsigned else 7.0
        # the scale rounded to its bf16 storage before it divides
        scale = (absmax * (RCP15 if act_unsigned else RCP7)).to(torch.bfloat16).float()
        q = torch.round(grp * rcp(scale)[..., None]).clamp(0.0 if act_unsigned else -qmax, qmax)
    else:
        s32 = absmax * RCP_E2M1_MAX
        # e4m3 rounding; above 464 XLA's conversion gives NaN where torch's saturates at 448
        scale = torch.where(s32 > E4M3_NAN_ABOVE, torch.nan, s32.to(torch.float8_e4m3fn).float())
        v = grp * rcp(scale)[..., None]
        # e2m1 round to nearest even: snap |v| to {0, .5, 1, 1.5, 2, 3, 4, 6},
        # spacing 2^(e-1) in binade e = clip(floor(log2 |v|), 0, 2)
        av = v.abs().clamp(0.0, E2M1_MAX)
        e = torch.floor(torch.log2(av.clamp_min(1.0))).clamp(0.0, 2.0)
        mag = torch.round(av * torch.exp2(1.0 - e)) * torch.exp2(e - 1.0)
        q = e2m1_value_to_code(torch.where(v < 0, -mag, mag))
    qact = pack_int4(q.reshape(m, k).to(torch.int8), -1)
    return qact, scale.t().to(torch.bfloat16).contiguous(), lora_act


# ---------------------------------------------------------------------------
# kernel 5: LayerNorm + AdaLN modulate + int8 quantize producer
# ---------------------------------------------------------------------------


def ln_mod_quant_int8_plain(x, mod_scale, mod_shift, smooth, proj_down):
    b, s, k = x.shape
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    # rsqrt rounded once (the kernel's __frsqrt_rn); the modulation as one
    # fused multiply-add (exact in f64, then rounded), as XLA contracts it
    y = d * torch.rsqrt((var + LN_EPS).double()).float()
    if mod_scale is not None:
        y = (y.double() * (1.0 + mod_scale.float()[:, None]).double()
             + mod_shift.float()[:, None].double()).float()
    y = y.reshape(b * s, k)
    lora_act = bf16_matmul(y, proj_down)  # the modulated y, before smoothing
    h = y if smooth is None else y * rsmooth_of(smooth)[None, :]
    scale = h.abs().amax(dim=-1) * RCP127
    q = torch.round(h * rcp(scale)[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(1, b * s), lora_act


def _ln_operands(x, mod_scale, mod_shift):
    """The kernel's checks of the stream and the modulation -> (x
    contiguous, mod scale, mod shift (f32 rows sharing one stride, or None),
    that stride)."""
    b, s, k = x.shape
    _build.require(x.dtype == torch.bfloat16, "x: bf16 residual stream expected")
    _build.require(k % 256 == 0 and k <= KERNEL_LN_MAX_K,
                   f"ln_mod_quant kernel needs K % 256 == 0 and K <= {KERNEL_LN_MAX_K} (K={k})")
    sc = sh = None
    ld = 0
    if mod_scale is not None:
        sc, sh = mod_scale.float(), mod_shift.float()
        if not (sc.stride() == sh.stride() and sc.stride(1) == 1):
            sc, sh = sc.contiguous(), sh.contiguous()
        ld = sc.stride(0)  # AdaLN chunks are (B, K) views of one (B, n*K) vector
        _build.require(tuple(sc.shape) == (b, k), f"mod vectors must be (B, K), got {tuple(sc.shape)}")
    return x.contiguous(), sc, sh, ld


def _ln_head(x, smooth, proj_down):
    """One head's operands and outputs for the kernel -> (smooth, proj_down
    padded to the kernel's rank step, q, ascales, lora_act, R, padded R)."""
    m, k = x.shape[0] * x.shape[1], x.shape[2]
    r = proj_down.shape[1]
    _build.require(smooth is None or smooth.dtype == torch.bfloat16, "smooth: bf16 expected")
    sm = None if smooth is None else smooth.contiguous()
    rp = -(-r // 16) * 16  # the kernel takes R in steps of 16 (its wgmma widths pad the rest with zeros)
    pd = proj_down.to(torch.bfloat16)
    if rp != r:
        pd = torch.nn.functional.pad(pd, (0, rp - r))
    qact = torch.empty((m, k), dtype=torch.int8, device=x.device)
    ascales = torch.empty((1, m), dtype=torch.float32, device=x.device)
    lora_act = torch.empty((m, rp), dtype=torch.float32, device=x.device)
    return sm, pd.contiguous(), qact, ascales, lora_act, r, rp


def _ln_result(q, asc, la, r, rp):
    return q, asc, la if rp == r else la[:, :r]


def ln_mod_quant_int8(x, mod_scale, mod_shift, smooth, proj_down):
    """``y = LN(x) * (1 + mod_scale) + mod_shift`` (f32, eps 1e-6), then the
    per-token int8 quantization of ``y / smooth`` with the low-rank
    ``lora_act = bf16(y) @ proj_down``.

    x (B, S, K) bf16; mod_scale / mod_shift (B, K) or both None (LayerNorm
    only); smooth (K,) or None; proj_down (K, R). Returns (qact (M, K) int8,
    ascales (1, M) f32, lora_act (M, R) f32) with M = B*S, unpadded -- the
    ``SVDQW4A4Linear.quantize`` contract."""
    if not x.is_cuda:
        return ln_mod_quant_int8_plain(x, mod_scale, mod_shift, smooth, proj_down)
    b, s, k = x.shape
    xc, sc, sh, ld = _ln_operands(x, mod_scale, mod_shift)
    sm, pd, qact, ascales, lora_act, r, rp = _ln_head(x, smooth, proj_down)
    lib = _build.library()
    _build.check(lib.nt_ln_mod_quant(
        xc.data_ptr(), None if sc is None else sc.data_ptr(), None if sh is None else sh.data_ptr(), ld,
        None if sm is None else sm.data_ptr(), pd.data_ptr(), qact.data_ptr(), ascales.data_ptr(),
        lora_act.data_ptr(), b * s, s, k, rp, torch.cuda.current_stream(x.device).cuda_stream), "ln_mod_quant")
    ln_mod_quant_int8.launches += 1
    return _ln_result(qact, ascales, lora_act, r, rp)


ln_mod_quant_int8.launches = 0


def ln_mod_quant_int8_dual_plain(x, mod_scale, mod_shift, smooth_a, proj_down_a, smooth_b, proj_down_b):
    """Two :func:`ln_mod_quant_int8_plain` calls on the same stream and
    modulation: the same LayerNorm, so the same y."""
    return (ln_mod_quant_int8_plain(x, mod_scale, mod_shift, smooth_a, proj_down_a),
            ln_mod_quant_int8_plain(x, mod_scale, mod_shift, smooth_b, proj_down_b))


def ln_mod_quant_int8_dual(x, mod_scale, mod_shift, smooth_a, proj_down_a, smooth_b, proj_down_b):
    """Shared-AdaLN dual producer: one read of x (B, S, K) bf16 and one
    ``y = LN(x) * (1 + mod_scale) + mod_shift`` (f32, eps 1e-6; mod_scale /
    mod_shift (B, K) are required, as in JAX), then for each head (smooth
    (K,) or None, proj_down (K, R), any R) the epilogue of
    :func:`ln_mod_quant_int8`. Returns ((qa (M, K) int8, sa (1, M) f32, la
    (M, R1) f32), (qb, sb, lb)) with M = B*S. Count ``ln_mod_quant_dual``."""
    if mod_scale is None or mod_shift is None:
        raise ValueError("ln_mod_quant_int8_dual needs mod_scale and mod_shift (JAX has no form without them)")
    if not x.is_cuda:
        return ln_mod_quant_int8_dual_plain(x, mod_scale, mod_shift, smooth_a, proj_down_a, smooth_b, proj_down_b)
    b, s, k = x.shape
    xc, sc, sh, ld = _ln_operands(x, mod_scale, mod_shift)
    sa, pda, qa, asa, laa, ra, rpa = _ln_head(x, smooth_a, proj_down_a)
    sb, pdb, qb, asb, lab, rb, rpb = _ln_head(x, smooth_b, proj_down_b)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    _build.check(lib.nt_ln_mod_quant_dual(
        xc.data_ptr(), sc.data_ptr(), sh.data_ptr(), ld, ptr(sa), pda.data_ptr(), qa.data_ptr(), asa.data_ptr(),
        laa.data_ptr(), ptr(sb), pdb.data_ptr(), qb.data_ptr(), asb.data_ptr(), lab.data_ptr(), b * s, s, k, rpa,
        rpb, torch.cuda.current_stream(x.device).cuda_stream), "ln_mod_quant_dual")
    ln_mod_quant_int8_dual.launches += 1
    return _ln_result(qa, asa, laa, ra, rpa), _ln_result(qb, asb, lab, rb, rpb)


ln_mod_quant_int8_dual.launches = 0
