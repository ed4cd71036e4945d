"""LoRA conversion CLI (counterpart of ``python -m nunchaku_tpu.lora.flux``).

Normalizes any supported LoRA flavor to the canonical (A, B) form and saves
it as a safetensors file with diffusers-style keys, ready for
``update_lora_params``: the JAX CLI's keys, dtype (bf16) and metadata.

Usage:
    python -m nunchaku_tpu_torch.lora.flux -i lora.safetensors -o converted.safetensors \
        [--strength 1.0]
"""

from __future__ import annotations

import argparse

import torch

from ...utils.safetensors import load_safetensors, save_safetensors
from .convert import to_canonical


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--strength", type=float, default=1.0)
    args = ap.parse_args(argv)

    sd, _ = load_safetensors(args.input)
    canonical = to_canonical(sd, strength=args.strength)
    out = {}
    for path, (a, b) in canonical.items():
        out[f"transformer.{path}.lora_A.weight"] = torch.from_numpy(a).to(torch.bfloat16)
        out[f"transformer.{path}.lora_B.weight"] = torch.from_numpy(b).to(torch.bfloat16)
    save_safetensors(args.output, out, {"format": "nunchaku_tpu-canonical-lora"})
    print(f"converted {len(canonical)} LoRA modules -> {args.output}")


if __name__ == "__main__":
    main()
