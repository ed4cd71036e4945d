"""LoRA normalization and composition for FLUX.

The port's own copy of ``nunchaku_tpu/lora/flux/convert.py`` (numpy only;
the port imports nothing of the JAX package), itself the counterpart of the
reference's nunchaku/lora/flux/diffusers_converter.py (:25-220
``to_diffusers``: kohya / comfyui / diffusers flavors) and compose.py
(:39-218 ``compose_lora``: several LoRAs with strengths, fused qkv
included). The input is a state dict of torch tensors (the port's
``utils.safetensors.load_safetensors``) or numpy arrays; the output is a
canonical dict

    {module_path: (A (r, K) f32, B (N, r) f32)}

of numpy arrays keyed by the FLUX model's module paths (attn.to_qkv,
ff.fc1, mlp_fc2, ...), equal to the JAX package's array for array. Fused
projections (to_qkv, add_qkv_proj) are assembled from per-q/k/v LoRAs by
stacking A and placing each B block at its part's rows; the single block's
``proj_out`` and ``qkv_mlp_fused`` are split by
``lora.flux.apply.update_lora_params`` (transformer_flux_v2.py:283-289 split
convention).
"""

from __future__ import annotations

import re

import numpy as np
import torch

# kohya double/single block tensor names -> diffusers-ish leaf
_KOHYA_DOUBLE = {
    "img_attn_qkv": "attn.to_qkv",
    "txt_attn_qkv": "attn.add_qkv_proj",
    "img_attn_proj": "attn.to_out",
    "txt_attn_proj": "attn.to_add_out",
    "img_mlp_0": "ff.fc1",
    "img_mlp_2": "ff.fc2",
    "txt_mlp_0": "ff_context.fc1",
    "txt_mlp_2": "ff_context.fc2",
    "img_mod_lin": "norm1.linear",
    "txt_mod_lin": "norm1_context.linear",
}
_KOHYA_SINGLE = {
    "linear1": "qkv_mlp_fused",  # qkv + mlp_fc1 fused in the bfl layout
    "linear2": "proj_out",
    "modulation_lin": "norm.linear",
}

_DIFFUSERS_LEAF = {
    "attn.to_q": ("attn.to_qkv", 0, 3),
    "attn.to_k": ("attn.to_qkv", 1, 3),
    "attn.to_v": ("attn.to_qkv", 2, 3),
    "attn.add_q_proj": ("attn.add_qkv_proj", 0, 3),
    "attn.add_k_proj": ("attn.add_qkv_proj", 1, 3),
    "attn.add_v_proj": ("attn.add_qkv_proj", 2, 3),
    "attn.to_out.0": ("attn.to_out", 0, 1),
    "attn.to_add_out": ("attn.to_add_out", 0, 1),
    "ff.net.0.proj": ("ff.fc1", 0, 1),
    "ff.net.2": ("ff.fc2", 0, 1),
    "ff_context.net.0.proj": ("ff_context.fc1", 0, 1),
    "ff_context.net.2": ("ff_context.fc2", 0, 1),
    "norm1.linear": ("norm1.linear", 0, 1),
    "norm1_context.linear": ("norm1_context.linear", 0, 1),
    "norm.linear": ("norm.linear", 0, 1),
    "proj_mlp": ("mlp_fc1", 0, 1),
    "proj_out": ("proj_out", 0, 1),
    # canonical (already-fused) names round-trip unchanged
    "attn.to_qkv": ("attn.to_qkv", 0, 1),
    "attn.add_qkv_proj": ("attn.add_qkv_proj", 0, 1),
    "attn.to_out": ("attn.to_out", 0, 1),
    "ff.fc1": ("ff.fc1", 0, 1),
    "ff.fc2": ("ff.fc2", 0, 1),
    "ff_context.fc1": ("ff_context.fc1", 0, 1),
    "ff_context.fc2": ("ff_context.fc2", 0, 1),
    "mlp_fc1": ("mlp_fc1", 0, 1),
    "mlp_fc2": ("mlp_fc2", 0, 1),
    "attn_out": ("attn_out", 0, 1),
}


def _f32(a) -> np.ndarray:
    """A torch tensor (bf16 included, widened exactly) or array -> f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def to_canonical(state_dict: dict, strength: float = 1.0) -> dict:
    """Normalize a LoRA state dict to {module_path: (A, B)} float32.

    Handles diffusers (``transformer.*.lora_A.weight``), peft
    (``*.lora_A.default.weight``), and kohya (``lora_unet_*`` /
    ``lora_transformer_*`` with lora_down/lora_up + alpha) flavors.
    """
    pairs: dict[str, dict] = {}

    def put(path, kind, arr, alpha=None):
        slot = pairs.setdefault(path, {})
        slot[kind] = _f32(arr)
        if alpha is not None:
            slot["alpha"] = float(alpha)

    for key, val in state_dict.items():
        k = key
        k = k.replace(".default.weight", ".weight")
        if k.startswith(("lora_unet_", "lora_transformer_")):
            body = re.sub(r"^lora_(unet|transformer)_", "", k)
            m = re.match(r"(double|single)_blocks_(\d+)_(.+?)\.(lora_down|lora_up|alpha)", body)
            if not m:
                continue
            kind_map = {"lora_down": "A", "lora_up": "B", "alpha": "alpha"}
            blk, idx, leaf, kind = m.group(1), int(m.group(2)), m.group(3), m.group(4)
            table = _KOHYA_DOUBLE if blk == "double" else _KOHYA_SINGLE
            if leaf not in table:
                continue
            base = "transformer_blocks" if blk == "double" else "single_transformer_blocks"
            path = f"{base}.{idx}.{table[leaf]}"
            if kind == "alpha":
                put(path, "alpha_only", None, alpha=_f32(val))
            else:
                put(path, kind_map[kind], val)
            continue

        k = k.removeprefix("transformer.").removeprefix("diffusion_model.")
        m = re.match(r"((?:single_)?transformer_blocks)\.(\d+)\.(.+?)\.(lora_A|lora_B)\.weight", k)
        if not m:
            continue
        stack, idx, leaf, kind = m.groups()
        if leaf not in _DIFFUSERS_LEAF:
            continue
        target, part, nparts = _DIFFUSERS_LEAF[leaf]
        path = f"{stack}.{idx}.{target}"
        put(f"{path}@@{part}of{nparts}" if nparts > 1 else path,
            "A" if kind == "lora_A" else "B", val)

    # fuse q/k/v parts into single projections
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    fused: dict[str, dict[int, tuple]] = {}
    nparts_of: dict[str, int] = {}
    for path, slot in pairs.items():
        if "@@" in path:
            base, tag = path.split("@@")
            part, nparts = (int(t) for t in tag.split("of"))
            nparts_of[base] = nparts
            fused.setdefault(base, {})[part] = (slot.get("A"), slot.get("B"))
            continue
        a, b_mat = slot.get("A"), slot.get("B")
        if a is None or b_mat is None:
            continue
        scale = strength * (slot.get("alpha", a.shape[0]) / a.shape[0])
        out[path] = (a * scale, b_mat)

    for base, parts in fused.items():
        # drop incomplete parts (A or B missing) rather than crash
        parts = {p: ab for p, ab in parts.items() if ab[0] is not None and ab[1] is not None}
        if not parts:
            continue
        # A LoRA may legally cover only a subset of q/k/v (diffusers format):
        # size B to the FULL fused width and place each part's rows at its
        # true offset part*inner, leaving missing parts zero.
        nparts = nparts_of[base]
        inner = next(iter(parts.values()))[1].shape[0]
        r_tot = sum(parts[p][0].shape[0] for p in sorted(parts))
        a_cat = np.concatenate([parts[p][0] for p in sorted(parts)], axis=0)
        b_cat = np.zeros((nparts * inner, r_tot), np.float32)
        col = 0
        for p in sorted(parts):
            _, b_mat = parts[p]
            assert b_mat.shape[0] == inner, (base, p, b_mat.shape, inner)
            b_cat[p * inner : (p + 1) * inner, col : col + b_mat.shape[1]] = b_mat
            col += b_mat.shape[1]
        out[base] = (a_cat * strength, b_cat)

    return out


def compose_lora(loras: list[tuple[dict, float]]) -> dict:
    """Merge several LoRAs (reference compose.py:39-218): concatenate ranks,
    folding each strength into its A block."""
    merged: dict[str, list] = {}
    for sd, strength in loras:
        for path, (a, b_mat) in to_canonical(sd, strength).items():
            merged.setdefault(path, []).append((a, b_mat))
    out = {}
    for path, parts in merged.items():
        a_cat = np.concatenate([a for a, _ in parts], axis=0)
        r_tot = a_cat.shape[0]
        n = parts[0][1].shape[0]
        b_cat = np.zeros((n, r_tot), np.float32)
        col = 0
        for a, b_mat in parts:
            b_cat[:, col : col + b_mat.shape[1]] = b_mat
            col += b_mat.shape[1]
        out[path] = (a_cat, b_cat)
    return out


def is_nunchaku_format(state_dict: dict) -> bool:
    """Reference lora/flux/utils.py:12 — already-converted dicts contain
    packed lora_down/lora_up with the base branch concatenated."""
    return any(".lora_down" in k or ".proj_down" in k for k in state_dict)
