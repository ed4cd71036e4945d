"""In-memory precision conversion of quantized linears and whole models.

Counterpart of ``nunchaku_tpu/models/requantize.py``: ``requantize_svdq``
(:49), ``requantize_model`` (:210) and ``w4a8_cache_dequant`` (:127). The int8
and w4a8 serving modes re-round a 4-bit model's residual weights as the
loader does from checkpoint tensors; this applies the same conversion to a
built model. A stacked linear (a (L, ...) qweight, the blocks of FLUX,
Qwen-Image and Z-Image) converts layer by layer, as the JAX loop over a
stack does, each layer copied into the new stack as it converts
(``linear.build_stacked``).

Rounding follows each JAX function's own form, so codes match bit for bit:
``_requant_int8_layer`` runs under ``jax.jit``, where XLA compiles
``absmax / 127.0`` into a multiply by f32(1/127) (:data:`RCP127` here, where
the loader divides), and ``w / scale`` stays a true division; round half to
even throughout.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from ..core.packing import unpack_int4
from ..ops.gemm import dequant_w4a8
from ..ops.reference import RCP127, decode_e2m1
from .linear import SVDQW4A4Linear, build_stacked, slice_module


def _per_layer(lin: SVDQW4A4Linear, fn) -> SVDQW4A4Linear:
    """``fn`` of a linear, layer by layer when it is stacked."""
    if lin.qweight.dim() == 2:
        return fn(lin)
    return build_stacked(lambda i: fn(slice_module(lin, i)), lin.qweight.shape[0])


def _requant_int8_layer(qw: torch.Tensor, ws: torch.Tensor, *, nvfp4: bool):
    """One (K/2, N) packed layer -> (int8 (K, N) codes, (1, N) f32 scale)."""
    vals = unpack_int4(qw, 0)
    vals = decode_e2m1(vals) if nvfp4 else vals.float()
    g = vals.shape[0] // ws.shape[0]
    w_deq = vals * ws.float().repeat_interleave(g, dim=0)
    absmax = w_deq.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax * RCP127)
    q8 = torch.round(w_deq / scale).clamp(-127, 127).to(torch.int8)
    return q8, scale


@torch.no_grad()
def requantize_svdq(lin: SVDQW4A4Linear, out_precision: str) -> SVDQW4A4Linear:
    """An int4 / nvfp4 SVDQ linear at the int8 or w4a8 serving precision.

    int8 dequantizes the group-scaled residual and re-rounds it to
    per-channel int8; w4a8 keeps the packed codes (an nvfp4 source its e2m1
    codes: nvfp4-a8) with a per-channel int8 scale and per-group rescales.
    A stacked linear converts layer by layer."""
    if lin.precision == out_precision:
        return lin
    if lin.precision not in ("int4", "nvfp4"):
        raise ValueError(f"cannot requantize from {lin.precision}")
    if lin.qweight.dim() == 3:
        return _per_layer(lin, lambda layer: requantize_svdq(layer, out_precision))
    ws = lin.wscales.float()  # (K/G, N)
    common = dict(smooth=lin.smooth, proj_down=lin.proj_down, proj_up=lin.proj_up, bias=lin.bias,
                  act_unsigned=lin.act_unsigned, logical_in=lin.logical_in, logical_out=lin.logical_out)
    qweight = lin.qweight.contiguous()  # packed (K/2, N) row-major, as w4a8 keeps it
    if out_precision == "w4a8":
        cmax = 6.0 if lin.precision == "nvfp4" else 7.0
        s8 = (ws.amax(dim=0, keepdim=True) * (cmax / 127.0)).clamp_min(1e-12)
        return SVDQW4A4Linear(qweight, s8, rescales=(ws / s8).to(torch.bfloat16), precision="w4a8",
                              wcodes="e2m1" if lin.precision == "nvfp4" else "int4", **common)
    if out_precision == "int8":
        q8, scale = _requant_int8_layer(qweight, ws, nvfp4=lin.precision == "nvfp4")
        return SVDQW4A4Linear(q8, scale, precision="int8", **common)
    raise ValueError(f"unsupported target precision {out_precision}")


def _svdq_children(model: nn.Module):
    """(parent, attribute, linear) of every SVDQW4A4Linear child."""
    return [(mod, name, child) for mod in model.modules() for name, child in mod.named_children()
            if isinstance(child, SVDQW4A4Linear)]


@torch.no_grad()
def requantize_model(model: nn.Module, out_precision: str, *, inplace: bool = False) -> nn.Module:
    """The model with every int4 / nvfp4 SVDQ linear converted to
    ``out_precision`` (int8 linears and the AWQ modulation linears stay, as
    in the JAX function); a deep copy unless ``inplace``. Each linear is
    replaced as it converts, so its packed copy is freed on the way."""
    new = model if inplace else copy.deepcopy(model)
    for mod, name, child in _svdq_children(new):
        if child.precision in ("int4", "nvfp4"):
            setattr(mod, name, requantize_svdq(child, out_precision))
    cfg = getattr(new, "cfg", None)
    if cfg is not None and hasattr(cfg, "precision"):
        new.cfg = dataclasses.replace(cfg, precision=out_precision)
    return new


def _int8_copy(lin: SVDQW4A4Linear) -> SVDQW4A4Linear:
    """A w4a8 linear's int8 twin: the dequant's codes, the same scales."""
    w8 = dequant_w4a8(lin.qweight, lin.rescales, lin.wcodes)
    return SVDQW4A4Linear(w8, lin.wscales, lin.smooth, lin.proj_down, lin.proj_up, lin.bias, precision="int8",
                          act_unsigned=lin.act_unsigned, logical_in=lin.logical_in, logical_out=lin.logical_out)


@torch.no_grad()
def w4a8_cache_dequant(model: nn.Module, budget_gib: float, *, inplace: bool = False) -> nn.Module:
    """Memory / speed dial of the w4a8 serving mode: spend up to
    ``budget_gib`` of extra device memory on int8 copies of the largest
    w4a8 linears, so their per-step dequant disappears. Each converted
    linear swaps its packed copy (0.5 B an element) for an int8 one (1 B):
    the budget counts the net growth, largest linears first (greedy by
    bytes). The int8 codes are exactly those the step's dequant produces
    (:func:`~nunchaku_tpu_torch.ops.gemm.dequant_w4a8`, the kernel on the
    card, int4 or e2m1 codes), so every converted linear's weights are
    code-exact; its output is the int8 route's. A stacked linear is one
    candidate of its whole stack's bytes, as in JAX, and dequantizes layer
    by layer. Returns a deep copy unless ``inplace``."""
    new = model if inplace else copy.deepcopy(model)
    cands = [(child.qweight.numel() * 2, mod, name) for mod, name, child in _svdq_children(new)
             if child.precision == "w4a8"]
    cands.sort(key=lambda t: -t[0])
    budget, spent = int(budget_gib * 2**30), 0
    for bytes_i8, mod, name in cands:
        net = bytes_i8 // 2  # the int8 copy replaces the packed one
        if spent + net > budget:
            continue
        spent += net
        child = getattr(mod, name)
        setattr(mod, name, _per_layer(child, _int8_copy))
        del child
    return new
