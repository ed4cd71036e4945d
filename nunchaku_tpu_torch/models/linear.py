"""Linear layers: plain bf16 ``Linear`` and the SVDQuant ``SVDQW4A4Linear``
at ``int8`` and ``w4a8``.

Counterparts of ``nunchaku_tpu/models/linear.py`` ``Linear`` (:61) and
``SVDQW4A4Linear`` (:87). Weights keep the JAX package's layouts: (K, N)
K-major, packed int4 as (K/2, N) in the block-split-half layout.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.gemm import svdq_gemm_w4a4
from ..ops.quantize import ln_mod_quant_int8, quantize_w4a4_act_fuse_lora
from ..ops.reference import GROUP_INT4, bf16_matmul

PAD_TOKENS = 256  # token padding quantum of the quantized linears (JAX linear.py:26)


def pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    return x if pad == 0 else nn.functional.pad(x, (0, 0, 0, pad))


def _randn(shape, gen, device, scale=1.0):
    return torch.randn(shape, generator=gen, device=device) * scale


class Linear(nn.Module):
    """Plain linear, weight (K, N): bf16 operands, f32 accumulation, result
    in the input's dtype."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    @classmethod
    def random_init(cls, gen, in_features, out_features, device="cuda"):
        std = 1.0 / math.sqrt(in_features)
        w = _randn((in_features, out_features), gen, device, std).to(torch.bfloat16)
        return cls(w, _randn((out_features,), gen, device, 0.02).to(torch.bfloat16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = bf16_matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


class SVDQW4A4Linear(nn.Module):
    """SVDQuant linear with a rank-r low-rank branch, at ``int8`` or ``w4a8``.

    Buffers (JAX layouts): ``qweight`` (K, N) int8 or packed (K/2, N) for
    w4a8; ``wscales`` (1, N) f32 per channel; ``rescales`` (K/64, N) bf16
    (w4a8 only); ``smooth`` (K,); ``proj_down`` (K, R); ``proj_up`` (R, N);
    ``bias`` (N,) or None. Always returns bf16. Activations are signed int8
    (the unsigned post-GELU codes of the JAX package are an int4 mode).
    """

    def __init__(self, qweight, wscales, smooth, proj_down, proj_up, bias=None, rescales=None, *,
                 precision: str = "w4a8"):
        super().__init__()
        if precision not in ("int8", "w4a8"):
            raise NotImplementedError(f"SVDQW4A4Linear precision {precision!r} is not ported")
        if precision == "int8":
            # same (K, N) values stored K-contiguous: the int8 tensor cores'
            # layout, like the dequant kernel's output for w4a8
            qweight = qweight.t().contiguous().t()
        for name, t in (("qweight", qweight), ("wscales", wscales), ("smooth", smooth),
                        ("proj_down", proj_down), ("proj_up", proj_up), ("bias", bias),
                        ("rescales", rescales)):
            self.register_buffer(name, t)
        self.precision = precision
        self.in_features = qweight.shape[0] * (2 if precision == "w4a8" else 1)
        self.out_features = qweight.shape[1]

    @classmethod
    def random_init(cls, gen, in_features, out_features, rank=32, precision="w4a8", device="cuda"):
        """The distributions of the JAX ``random_init`` (linear.py:134-197).
        FLUX's dims need none of the JAX package's odd-dim K/N padding."""
        std = 1.0 / math.sqrt(in_features)
        if in_features % 256 or out_features % 128:
            raise ValueError("the port takes kernel-aligned dims (K % 256, N % 128)")
        ws = (_randn((1, out_features), gen, device).abs() * std / 127).float()
        rescales = None
        if precision == "int8":
            qw = torch.randint(-128, 128, (in_features, out_features), dtype=torch.int8,
                               generator=gen, device=device)
        elif precision == "w4a8":
            qw = torch.randint(-128, 128, (in_features // 2, out_features), dtype=torch.int8,
                               generator=gen, device=device)
            rescales = (torch.rand((in_features // GROUP_INT4, out_features), generator=gen,
                                   device=device) * (127.0 / 7.0 - 1.0) + 1.0).to(torch.bfloat16)
        else:
            raise NotImplementedError(f"precision {precision!r} is not ported")
        smooth = torch.ones((in_features,), dtype=torch.bfloat16, device=device)
        pd = _randn((in_features, rank), gen, device, 0.02).to(torch.bfloat16)
        pu = _randn((rank, out_features), gen, device, 0.02).to(torch.bfloat16)
        b = _randn((out_features,), gen, device, 0.02).to(torch.bfloat16)
        return cls(qw, ws, smooth, pd, pu, b, rescales, precision=precision)

    def quantize(self, x2d: torch.Tensor):
        """(M, K) -> (qact, ascales (1, M'), lora_act), M padded to 256
        (to 8 when M <= 8)."""
        x2d = pad_rows(x2d, 8 if x2d.shape[0] <= 8 else PAD_TOKENS)
        return quantize_w4a4_act_fuse_lora(x2d, self.proj_down, self.smooth,
                                           precision=self.precision)

    def forward_quant(self, qact, ascales, lora_act, *, skip_lora=False, residual=None):
        """The GEMM on quantized activations. ``skip_lora`` leaves out the
        low-rank epilogue (the caller adds ``lora_act @ proj_up`` itself);
        ``residual`` is :func:`~nunchaku_tpu_torch.ops.gemm.res_apply`'s
        operands."""
        return svdq_gemm_w4a4(qact, ascales, self.qweight, self.wscales, None if skip_lora else lora_act,
                              None if skip_lora else self.proj_up, self.bias, self.rescales,
                              precision=self.precision, residual=residual)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        m = math.prod(lead)
        out = self.forward_quant(*self.quantize(x.reshape(m, x.shape[-1])))
        return out[:m].reshape(*lead, out.shape[-1])

    def forward_parts(self, x: torch.Tensor):
        """Like :meth:`forward` without the low-rank epilogue: returns
        ``(out_without_lora, lora_act)`` so the caller can add the low-rank
        term downstream (the chain consumer's residual epilogue)."""
        lead = x.shape[:-1]
        m = math.prod(lead)
        q, a, la = self.quantize(x.reshape(m, x.shape[-1]))
        out = self.forward_quant(q, a, la, skip_lora=True)
        return out[:m].reshape(*lead, out.shape[-1]), la[:m].reshape(*lead, la.shape[-1])

    def forward_modulated(self, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                          skip_lora=False):
        """``LN(x) * (1 + scale) + shift`` -> this linear, x (B, S, K) the raw
        bf16 stream, scale / shift (B, K): one LN + modulate + quantize
        producer (:func:`~nunchaku_tpu_torch.ops.quantize.ln_mod_quant_int8`)
        feeds the GEMM at any S (the kernel masks the rows past B*S, so the
        JAX method's multi-pass fallback for an S without a tile divisor has
        no counterpart here). ``skip_lora`` returns ``(out_without_lora,
        lora_act (B, S, R))``."""
        b, s, _ = x.shape
        q, asc, la = ln_mod_quant_int8(x.to(torch.bfloat16), scale, shift, self.smooth, self.proj_down)
        out = self.forward_quant(q, asc, la, skip_lora=skip_lora).reshape(b, s, -1)
        return (out, la.reshape(b, s, -1)) if skip_lora else out
