"""Z-Image (S3-DiT) text-to-image pipeline (counterpart of
``nunchaku_tpu/pipeline/pipeline_zimage.py``), from prompt embeddings: a
Qwen-family encoder's hidden states (B, S_txt, cap_feat_dim). The JAX
package has no Z-Image text encoder and its pipeline leaves its
``text_encoder`` / ``tokenizer`` arguments unused, so the port takes
neither. A flow-matching Euler schedule over shifted static sigmas
(:func:`zimage_sigmas`, shift 3.0); the transformer conditioned on
``1 - sigma`` and its output taken as the NEGATIVE velocity
(``velocity_sign = -1``, the Lumina2 convention); CFG as a second B-size
forward only when ``negative_prompt_embeds`` are given and
``guidance_scale > 0``; then the FLUX ``AutoencoderKL`` decode. The JAX
``lax.scan`` of ``_zimage_denoise`` (:100-118) is a Python loop. The default
noise comes from a ``torch.Generator``, not ``jax.random``; parity runs pass
``latents``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .pipeline_flux import make_img_ids, pack_latents, unpack_latents
from .scheduler import euler_step


@dataclass
class ZImagePipelineOutput:
    images: torch.Tensor | None  # (B, H, W, 3) f32 in [0, 1]; None without an autoencoder
    latents: torch.Tensor  # (B, S_img, in_channels * p^2) bf16 packed tokens


def zimage_sigmas(num_steps: int, shift: float = 3.0) -> np.ndarray:
    """(num_steps + 1,) shifted flow-matching sigmas from 1 to 1/num_steps, then 0."""
    s = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    s = shift * s / (1.0 + (shift - 1.0) * s)
    return np.concatenate([s, [0.0]]).astype(np.float32)


class ZImagePipeline:
    def __init__(self, transformer, vae=None):
        self.transformer = transformer
        self.vae = vae

    @torch.no_grad()
    def __call__(self, prompt_embeds: torch.Tensor, height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 8, guidance_scale: float = 0.0,
                 negative_prompt_embeds: torch.Tensor | None = None, shift: float = 3.0, seed: int = 0,
                 latents: torch.Tensor | None = None, velocity_sign: float = -1.0) -> ZImagePipelineOutput:
        model = self.transformer
        cfg = model.cfg
        device = prompt_embeds.device
        b = prompt_embeds.shape[0]
        lh, lw = height // 8, width // 8
        p = cfg.patch_size
        if latents is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            latents = pack_latents(torch.randn((b, cfg.in_channels, lh, lw), generator=gen, device=device))
        lat = latents.float()
        img_ids = make_img_ids(lh // p, lw // p, device)
        txt_ids = torch.zeros((prompt_embeds.shape[1], 3), dtype=torch.int32, device=device)
        sigmas = zimage_sigmas(num_inference_steps, shift)
        use_cfg = negative_prompt_embeds is not None and guidance_scale > 0.0
        sign = float(np.float32(velocity_sign))
        g = float(np.float32(guidance_scale))
        for i in range(num_inference_steps):
            t = torch.full((b,), float(np.float32(1.0) - sigmas[i]), dtype=torch.float32, device=device)
            vel = model(lat.to(torch.bfloat16), prompt_embeds, t, img_ids, txt_ids).float()
            if use_cfg:
                neg = model(lat.to(torch.bfloat16), negative_prompt_embeds, t, img_ids, txt_ids).float()
                vel = neg + g * (vel - neg)
            lat = euler_step(lat, sign * vel, sigmas[i], sigmas[i + 1])
        out = lat.to(torch.bfloat16)
        images = None
        if self.vae is not None:
            images = self.vae.decode(unpack_latents(out, lh, lw).to(torch.bfloat16))
        return ZImagePipelineOutput(images=images, latents=out)
