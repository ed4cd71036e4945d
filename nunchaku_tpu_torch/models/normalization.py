"""LayerNorm and the AdaLN modulations of FLUX.

Counterparts of ``nunchaku_tpu/models/normalization.py``. The modulation
linears follow ``_mod_linear``: AWQ W4A16 for the int4 / nvfp4 models,
int8 SVDQ linears with a zero low-rank branch for int8 / w4a8 / nvfp4-a8.
``scale_shift`` is the constant added to the attention branch's AdaLN scale:
1 (``LN(x) * (1 + scale)``), or 0 for nunchaku's FLUX checkpoints, which fold
the +1 into the modulation weights (the JAX loader, ``loader.py:11-12``).
As in the JAX package, ``mod_vectors`` shifts both scales by
``scale_shift - 1`` for the fused producers, while the unfused block adds 1
to its MLP scale.
"""

from __future__ import annotations

from torch import nn

from ..ops.reference import is_4bit, layer_norm
from .linear import AWQW4A16Linear, Linear, SVDQW4A4Linear


def mod_linear(gen, dim, out_dim, precision="w4a8", device="cuda"):
    """The modulation linear of a ``precision`` model (JAX ``_mod_linear``):
    AWQ W4A16 for int4 / nvfp4, else (int8, w4a8, nvfp4-a8) int8 SVDQ with
    a zero rank-16 branch."""
    if is_4bit(precision):
        return AWQW4A16Linear.random_init(gen, dim, out_dim, device=device)
    lin = SVDQW4A4Linear.random_init(gen, dim, out_dim, rank=16, precision="int8", device=device)
    lin.proj_down.zero_()
    lin.proj_up.zero_()
    return lin


def _modulation(linear, temb):
    return linear(nn.functional.silu(temb.float()).to(temb.dtype)).float()


def _shift_scales(parts, scale_shift, idx):
    """The modulation vectors with ``scale_shift - 1`` added to the scales
    at ``idx``, for consumers that compute ``1 + scale``."""
    parts = list(parts)
    if scale_shift != 1.0:
        for i in idx:
            parts[i] = parts[i] + (scale_shift - 1.0)
    return parts


class AdaLayerNormZero(nn.Module):
    """LN(x) * (scale_shift + scale) + shift; returns (norm_x, gate_msa,
    shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, linear, scale_shift: float = 1.0):
        super().__init__()
        self.linear = linear
        self.scale_shift = scale_shift

    @classmethod
    def random_init(cls, gen, dim, precision="w4a8", device="cuda"):
        return cls(mod_linear(gen, dim, 6 * dim, precision, device))

    def forward(self, x, temb):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = _modulation(
            self.linear, temb).chunk(6, dim=-1)
        out = layer_norm(x) * (scale_msa[:, None] + self.scale_shift) + shift_msa[:, None]
        return out.to(x.dtype), gate_msa, shift_mlp, scale_mlp, gate_mlp

    def mod_vectors(self, temb):
        """The six (B, D) f32 modulation vectors (shift_msa, scale_msa,
        gate_msa, shift_mlp, scale_mlp, gate_mlp) without the norm, for the
        fused LN + modulate + quantize producer; both scales pre-adjusted for
        ``1 + scale``."""
        return _shift_scales(_modulation(self.linear, temb).chunk(6, dim=-1), self.scale_shift, (1, 4))


class AdaLayerNormZeroSingle(nn.Module):
    """Single-stream variant: returns (norm_x, gate_msa)."""

    def __init__(self, linear, scale_shift: float = 1.0):
        super().__init__()
        self.linear = linear
        self.scale_shift = scale_shift

    @classmethod
    def random_init(cls, gen, dim, precision="w4a8", device="cuda"):
        return cls(mod_linear(gen, dim, 3 * dim, precision, device))

    def forward(self, x, temb):
        shift_msa, scale_msa, gate_msa = _modulation(self.linear, temb).chunk(3, dim=-1)
        out = layer_norm(x) * (scale_msa[:, None] + self.scale_shift) + shift_msa[:, None]
        return out.to(x.dtype), gate_msa

    def mod_vectors(self, temb):
        """(shift_msa, scale_msa, gate_msa), each (B, D) f32, without the
        norm; the scale pre-adjusted for ``1 + scale``."""
        return _shift_scales(_modulation(self.linear, temb).chunk(3, dim=-1), self.scale_shift, (1,))


class AdaLayerNormContinuous(nn.Module):
    """Output-head norm: LN(x) * (1 + scale) + shift from temb."""

    def __init__(self, linear: Linear):
        super().__init__()
        self.linear = linear

    @classmethod
    def random_init(cls, gen, dim, device="cuda"):
        return cls(Linear.random_init(gen, dim, 2 * dim, device=device))

    def forward(self, x, temb):
        scale, shift = _modulation(self.linear, temb).chunk(2, dim=-1)
        out = layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]
        return out.to(x.dtype)
