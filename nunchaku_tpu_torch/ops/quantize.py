"""Per-token int8 activation quantization with the fused low-rank down-projection.

* :func:`quantize_w4a4_act_fuse_lora` -- the int8/w4a8 branch of
  ``nunchaku_tpu/ops/quantize.py`` ``quantize_w4a4_act_fuse_lora``
  (:40-102), which JAX leaves to XLA; here it is plain PyTorch.
* :func:`ln_mod_quant_int8` -- kernel ``csrc/ln_mod_quant.cu`` (JAX
  ``_ln_mod_quant_kernel`` :149, ``ln_mod_quant_int8`` :179): LayerNorm,
  AdaLN modulation and the same quantization in one pass over the bf16
  residual stream.

The low-rank activation ``lora_act = bf16(x) @ proj_down`` uses the raw
(or modulated) activation; the quantized codes use ``x / smooth`` (through
a reciprocal), one absmax/127 scale per token, round half to even and clip
to +-127.
"""

from __future__ import annotations

import torch

from . import _build
from .reference import RCP127, bf16_matmul

LN_EPS = 1e-6
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


def quantize_w4a4_act_fuse_lora(x: torch.Tensor, proj_down: torch.Tensor,
                                smooth: torch.Tensor | None = None, *,
                                precision: str = "int8"):
    """(M, K) activations -> (qact (M, K) int8, ascales (1, M) f32,
    lora_act (M, R) f32)."""
    if precision not in ("int8", "w4a8"):
        raise NotImplementedError(f"activation quantization for {precision!r} is not ported")
    m = x.shape[0]
    lora_act = bf16_matmul(x, proj_down)
    xs = x.float()
    if smooth is not None:
        xs = xs * rsmooth_of(smooth)[None, :]
    scale = xs.abs().amax(dim=-1) * RCP127
    q = torch.round(xs * rcp(scale)[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(1, m), lora_act


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
    m = b * s
    r = proj_down.shape[1]
    _build.require(x.dtype == torch.bfloat16, "x: bf16 residual stream expected")
    _build.require(k % 256 == 0 and k <= KERNEL_LN_MAX_K,
                   f"ln_mod_quant kernel needs K % 256 == 0 and K <= {KERNEL_LN_MAX_K} (K={k})")
    _build.require(r <= 32, f"rank {r} > 32")
    xc = x.contiguous()
    sc = sh = None
    ld = 0
    if mod_scale is not None:
        sc, sh = mod_scale.float(), mod_shift.float()
        if not (sc.stride() == sh.stride() and sc.stride(1) == 1):
            sc, sh = sc.contiguous(), sh.contiguous()
        ld = sc.stride(0)  # AdaLN chunks are (B, K) views of one (B, n*K) vector
        _build.require(tuple(sc.shape) == (b, k), f"mod vectors must be (B, K), got {tuple(sc.shape)}")
    _build.require(smooth is None or smooth.dtype == torch.bfloat16, "smooth: bf16 expected")
    sm = None if smooth is None else smooth.contiguous()
    rp = -(-r // 16) * 16  # the kernel's WMMA tile takes R in steps of 16
    pd = proj_down.to(torch.bfloat16)
    if rp != r:
        pd = torch.nn.functional.pad(pd, (0, rp - r))
    pd = pd.contiguous()
    qact = torch.empty((m, k), dtype=torch.int8, device=x.device)
    ascales = torch.empty((1, m), dtype=torch.float32, device=x.device)
    lora_act = torch.empty((m, rp), dtype=torch.float32, device=x.device)
    lib = _build.library()
    _build.check(lib.nt_ln_mod_quant(
        xc.data_ptr(), None if sc is None else sc.data_ptr(), None if sh is None else sh.data_ptr(), ld,
        None if sm is None else sm.data_ptr(), pd.data_ptr(), qact.data_ptr(), ascales.data_ptr(),
        lora_act.data_ptr(), m, s, k, rp, torch.cuda.current_stream(x.device).cuda_stream), "ln_mod_quant")
    ln_mod_quant_int8.launches += 1
    return qact, ascales, lora_act if rp == r else lora_act[:, :r]


ln_mod_quant_int8.launches = 0

