"""LoRA on the quantized FLUX model, applied at run time.

Counterpart of ``nunchaku_tpu/lora/flux/apply.py`` (``update_lora_params``
:81, ``set_lora_strength`` :218), itself the reference's
``update_lora_params`` / ``set_lora_strength`` (nunchaku/models/transformers/
transformer_flux.py:783-855). A LoRA's ranks are appended to the low-rank
branch of each quantized linear it touches: ``proj_down`` gains columns,
``proj_up`` rows, so the GEMM kernels take it in their low-rank term with no
extra launch. The appended ``proj_up`` rows are ``unit * strength``;
``lora_up_unit`` keeps the unit rows, so :func:`set_lora_strength` sets the
strength absolutely (the reference's ``setLoraScale``, csrc/flux.h:177-198).
The AdaLN modulation linears of a 4-bit model (AWQ W4A16) take the LoRA as
their side branch; a plain ``Linear`` takes it folded into its weight, the
strength baked in.

The blocks are stacks (``models.linear.stack_modules``), whose layers share
one rank per leaf: a leaf's layers are padded with zeros to the largest rank
any layer of it has (JAX :105-150). Functional, as in JAX: the input model is
untouched, and the new model shares every buffer the LoRA does not change
with it (the 4-bit weights are not copied); only the low-rank stacks of the
touched leaves are new. Apply a LoRA before ``enable_fused_qkv_prep()``
(JAX's documented order, transformer_flux.py:386-387): on a model in the
half-split q/k order ``update_lora_params`` raises.

bf16 rounding is JAX's: A and B round to the buffers' dtype from f32, and
``unit * strength`` multiplies the bf16 unit rows by the strength rounded to
bf16 (JAX's weak-typed Python scalar), so the buffers equal JAX's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...models.linear import AWQW4A16Linear, Linear, SVDQW4A4Linear, fork_module
from .convert import to_canonical

RANK_PAD = 16  # appended ranks are padded to a multiple of 16 (the reference packs LoRA scales per 16 ranks)
STACKS = ("transformer_blocks", "single_transformer_blocks")


def _pad_rank(a: np.ndarray, axis: int) -> np.ndarray:
    pad = (-a.shape[axis]) % RANK_PAD
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """An f32 numpy array on ``device``, rounded to ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device).to(dtype)


def _scaled(unit: torch.Tensor, strength: float) -> torch.Tensor:
    """``unit * strength`` as JAX computes it: the strength rounded to the
    unit's dtype first (a weak-typed Python scalar), one rounding of the
    product."""
    return unit * torch.tensor(strength, dtype=unit.dtype)


def _layer_state(mod: nn.Module, i: int) -> dict:
    """Layer ``i``'s low-rank tensors of a stacked linear (views into it)."""
    if isinstance(mod, SVDQW4A4Linear):
        unit = mod.lora_up_unit
        return dict(pd=mod.proj_down[i], pu=mod.proj_up[i], unit=None if unit is None else unit[i],
                    base=mod.lora_base_rank)
    if isinstance(mod, AWQW4A16Linear):
        return {name: None if getattr(mod, name) is None else getattr(mod, name)[i]
                for name in ("lora_down", "lora_up", "lora_up_unit")}
    return dict(weight=mod.weight[i])


def _extend(mod: nn.Module, st: dict, a: np.ndarray, b: np.ndarray, strength: float) -> None:
    """One LoRA (A (r, K), B (N, r)) onto one layer's state (JAX
    ``_extend_svdq`` :39, ``_extend_awq`` :69, the plain fold :200-205)."""
    if isinstance(mod, SVDQW4A4Linear):
        pd, pu = st["pd"], st["pu"]
        unit = _tensor(_pad_rank(b, 1).T, pu.dtype, pu.device)
        if st["unit"] is None:  # a second LoRA keeps the base rank of the first
            st["base"] = pu.shape[0]
        st["pd"] = torch.cat([pd, _tensor(_pad_rank(a, 0).T, pd.dtype, pd.device)], dim=1)
        st["pu"] = torch.cat([st["pu"], _scaled(unit, strength)], dim=0)
        st["unit"] = unit if st["unit"] is None else torch.cat([st["unit"], unit], dim=0)
    elif isinstance(mod, AWQW4A16Linear):
        # as in JAX, the side branch holds the last LoRA applied to this layer
        dev = mod.qweight.device
        st["lora_up_unit"] = _tensor(b.T, torch.bfloat16, dev)
        st["lora_down"] = _tensor(a.T, torch.bfloat16, dev)
        st["lora_up"] = _scaled(st["lora_up_unit"], strength)
    else:
        w = st["weight"]
        delta = np.float32(strength) * (b @ a).T
        st["weight"] = (w.float() + torch.from_numpy(np.ascontiguousarray(delta)).to(w.device)).to(w.dtype)


def _padded(t: torch.Tensor | None, shape, like: torch.Tensor) -> torch.Tensor:
    """``t`` zero-padded at its ends to the 2-D ``shape``; None -> zeros of
    ``like``'s dtype and device."""
    if t is None:
        return like.new_zeros(shape)
    return nn.functional.pad(t, (0, shape[1] - t.shape[1], 0, shape[0] - t.shape[0]))


def _restack(mod: nn.Module, states: list[dict]) -> None:
    """Write the layers' states back as new stacks of one rank per leaf,
    zero-padded to the largest (JAX :105-150)."""
    if isinstance(mod, SVDQW4A4Linear):
        target = max(st["pd"].shape[1] for st in states)
        k, n = states[0]["pd"].shape[0], states[0]["pu"].shape[1]
        mod.proj_down = torch.stack([_padded(st["pd"], (k, target), None) for st in states])
        mod.proj_up = torch.stack([_padded(st["pu"], (target, n), None) for st in states])
        with_unit = [st for st in states if st["unit"] is not None]
        if with_unit:
            base = with_unit[-1]["base"]
            mod.lora_up_unit = torch.stack([_padded(st["unit"], (target - base, n), mod.proj_up) for st in states])
            mod.lora_base_rank = base
    elif isinstance(mod, AWQW4A16Linear):
        target = max(0 if st["lora_down"] is None else st["lora_down"].shape[1] for st in states)
        if target == 0:
            return
        k, n, bf16 = mod.in_features, mod.out_features, mod.wscales  # the modulation's scales: bf16, on its device
        mod.lora_down = torch.stack([_padded(st["lora_down"], (k, target), bf16) for st in states])
        mod.lora_up = torch.stack([_padded(st["lora_up"], (target, n), bf16) for st in states])
        mod.lora_up_unit = torch.stack([_padded(st["lora_up_unit"], (target, n), bf16) for st in states])
    else:
        mod.weight = torch.stack([st["weight"] for st in states])


def _targets(stacked: nn.Module, leaf: str, a, b, single: bool):
    """The (leaf, A, B) pieces of one canonical entry: a single block's fused
    ``proj_out`` (K = dim | 4 dim) and ``qkv_mlp_fused`` ([qkv | mlp_fc1] on
    the output side) split as in JAX :168-180."""
    if single and leaf == "proj_out":
        dim = stacked.attn_out.in_features
        return [("attn_out", a[:, :dim], b), ("mlp_fc2", a[:, dim:], b)]
    if single and leaf == "qkv_mlp_fused":
        n_qkv = stacked.attn.to_qkv.out_features
        return [("attn.to_qkv", a, b[:n_qkv]), ("mlp_fc1", a, b[n_qkv:])]
    return [(leaf, a, b)]


def _module(stacked: nn.Module, leaf: str) -> nn.Module | None:
    obj = stacked
    for part in leaf.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj if isinstance(obj, (SVDQW4A4Linear, AWQW4A16Linear, Linear)) else None


def _apply_stack(stacked: nn.Module, name: str, lora: dict, strength: float) -> None:
    touched: dict[str, list[dict]] = {}
    for path, (a, b) in lora.items():
        if not path.startswith(name + "."):
            continue
        _, idx, *leaf = path.split(".")
        for target, a2, b2 in _targets(stacked, ".".join(leaf), a, b, name == "single_transformer_blocks"):
            mod = _module(stacked, target)
            if mod is None:
                continue
            if target not in touched:
                layers = next(t for t in mod.buffers()).shape[0]
                touched[target] = [_layer_state(mod, i) for i in range(layers)]
            _extend(mod, touched[target][int(idx)], a2, b2, strength)
    for target, states in touched.items():
        _restack(_module(stacked, target), states)


def _is_canonical(sd: dict) -> bool:
    return bool(sd) and all(isinstance(v, tuple) and len(v) == 2 for v in sd.values())


@torch.no_grad()
def update_lora_params(model, lora_state_dict: dict, strength: float = 1.0):
    """A new ``FluxTransformer2DModel`` with the LoRA in its low-rank
    branches; ``model`` is untouched and shares its other buffers with it.

    ``lora_state_dict``: a LoRA state dict of any supported flavor (torch
    tensors or numpy arrays; converted at unit strength) or a canonical
    ``{path: (A, B)}`` dict from ``compose_lora``."""
    if model.rope_halfsplit:
        raise ValueError("apply a LoRA before enable_fused_qkv_prep(): the model's q/k channels are in half-split "
                         "order and a LoRA's are not")
    lora = lora_state_dict if _is_canonical(lora_state_dict) else to_canonical(lora_state_dict, 1.0)
    new = fork_module(model)
    for name in STACKS:
        _apply_stack(getattr(new, name), name, lora, strength)
    new._views = None
    return new


@torch.no_grad()
def set_lora_strength(model, strength: float):
    """A new model whose LoRA rows are ``unit * strength``: absolute, so
    ``set_lora_strength(set_lora_strength(m, 0.5), 1.0)`` equals
    ``set_lora_strength(m, 1.0)`` (JAX :218-248). New tensors: the LoRA'd
    leaves' ``proj_up`` stacks (base rows copied, LoRA rows set) and the AWQ
    ``lora_up`` stacks; the rest is shared with ``model``."""
    new = fork_module(model)
    for name in STACKS:
        for _, m in getattr(new, name).named_modules():
            unit = getattr(m, "lora_up_unit", None)
            if unit is None:
                continue
            if isinstance(m, SVDQW4A4Linear):
                rows = _scaled(unit, strength).to(m.proj_up.dtype)
                m.proj_up = torch.cat([m.proj_up[:, :m.lora_base_rank], rows], dim=1)
            elif m.lora_up is not None:
                m.lora_up = _scaled(unit, strength).to(m.lora_up.dtype)
    new._views = None
    return new
