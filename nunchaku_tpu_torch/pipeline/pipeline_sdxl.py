"""SDXL text-to-image pipeline (counterpart of
``nunchaku_tpu/pipeline/pipeline_sdxl.py``): the EulerDiscrete sigma
schedule over SDXL's scaled-linear betas, epsilon prediction, SDXL's
text_time conditioning (pooled embeddings plus the size / crop time ids),
classifier-free guidance as two batch-1 UNet calls per step (JAX
``_sdxl_denoise`` :105-123), and an optional VAE decode.

Text encoding stays outside, as in JAX: pass ``prompt_embeds`` (B, 77,
2048; CLIP-L and OpenCLIP-G penultimate states) and
``pooled_prompt_embeds`` (B, 1280). The default noise comes from a
``torch.Generator``, not ``jax.random``; parity runs pass ``latents``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SDXLPipelineOutput:
    images: torch.Tensor | None  # (B, H, W, 3) f32 in [0, 1]; None without a VAE
    latents: torch.Tensor  # (B, 4, h, w) f32, NCHW


def sdxl_sigmas(num_steps: int, train_steps: int = 1000):
    """EulerDiscrete sigmas (num_steps + 1, ending in 0) and the matching
    discrete timesteps ("leading" spacing, steps_offset 1: SDXL's scheduler
    config), f32 numpy, the JAX function's arithmetic."""
    betas = np.linspace(0.00085**0.5, 0.012**0.5, train_steps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    all_sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
    step = train_steps // num_steps
    ts = (np.arange(num_steps) * step + 1).round()[::-1].astype(np.int64)
    return np.concatenate([all_sigmas[ts], [0.0]]).astype(np.float32), ts.astype(np.float32)


class SDXLPipeline:
    def __init__(self, unet, vae=None, text_encoder=None, text_encoder_2=None, tokenizer=None, tokenizer_2=None):
        self.unet = unet
        self.vae = vae
        self.text_encoder = text_encoder
        self.text_encoder_2 = text_encoder_2
        self.tokenizer = tokenizer
        self.tokenizer_2 = tokenizer_2

    @torch.no_grad()
    def __call__(self, prompt_embeds: torch.Tensor, pooled_prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: torch.Tensor | None = None,
                 negative_pooled_prompt_embeds: torch.Tensor | None = None,
                 height: int = 1024, width: int = 1024, num_inference_steps: int = 30,
                 guidance_scale: float = 5.0, seed: int = 0,
                 latents: torch.Tensor | None = None) -> SDXLPipelineOutput:
        """Guidance runs when negative embeddings are given and
        ``guidance_scale > 1`` (SDXL-Turbo: 4 steps at guidance 0)."""
        device = prompt_embeds.device
        b = prompt_embeds.shape[0]
        lh, lw = height // 8, width // 8
        sigmas, ts = sdxl_sigmas(num_inference_steps)
        if latents is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            lat = torch.randn((b, 4, lh, lw), generator=gen, device=device)
            lat = lat * float(np.sqrt(sigmas[0] ** 2 + 1.0))  # init_noise_sigma
        else:
            lat = latents.float()
        time_ids = torch.tensor([[height, width, 0, 0, height, width]] * b, dtype=torch.float32, device=device)
        use_cfg = negative_prompt_embeds is not None and guidance_scale > 1.0
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        cfg_scale = f32(guidance_scale)
        for i in range(num_inference_steps):
            sigma, sigma_next = f32(sigmas[i]), f32(sigmas[i + 1])
            x_in = (lat / torch.sqrt(sigma * sigma + 1.0)).to(torch.bfloat16)  # EulerDiscrete input scaling
            tvec = torch.full((b,), float(ts[i]), dtype=torch.float32, device=device)
            eps = self.unet(x_in, tvec, prompt_embeds, pooled_prompt_embeds, time_ids).float()
            if use_cfg:
                eps_n = self.unet(x_in, tvec, negative_prompt_embeds, negative_pooled_prompt_embeds,
                                  time_ids).float()
                eps = eps_n + cfg_scale * (eps - eps_n)
            lat = lat + (sigma_next - sigma) * eps  # epsilon prediction: the derivative is eps
        images = None
        if self.vae is not None:
            images = self.vae.decode(lat.to(torch.bfloat16))
        return SDXLPipelineOutput(images=images, latents=lat)
