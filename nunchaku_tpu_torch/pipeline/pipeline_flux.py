"""FLUX text-to-image pipeline (counterpart of
``nunchaku_tpu/pipeline/pipeline_flux.py`` for a prompt or its embeddings,
the first-block caches ``"fb"`` and ``"double_fb"``, and an optional VAE).
A prompt is encoded from token ids by the T5 (sequence) and CLIP (pooled)
encoders, each behind a tokenizer: any callable ``tokenizer(prompts,
max_length) -> (B, max_length) ids``, as in JAX. The denoise loop is a
Python loop of transformer forwards (cached or not) and Euler steps; with a
VAE the latents are decoded to images.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..caching.fbcache import fb_cached_forward, init_fb_state, make_hit_schedule
from .scheduler import euler_step, flux_sigmas

CACHES = (None, "fb", "double_fb")
CLIP_MAX_LENGTH = 77  # CLIP's token positions


def pack_latents(lat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2*W/2, C*4) 2x2 patchified tokens."""
    b, c, h, w = lat.shape
    x = lat.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, S, C*4) -> (B, C, H, W)."""
    b, _, c4 = tokens.shape
    c = c4 // 4
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def make_img_ids(h_tokens: int, w_tokens: int, device="cpu") -> torch.Tensor:
    ids = np.zeros((h_tokens * w_tokens, 3), np.int32)
    ids[:, 1] = np.repeat(np.arange(h_tokens), w_tokens)
    ids[:, 2] = np.tile(np.arange(w_tokens), h_tokens)
    return torch.from_numpy(ids).to(device)


@dataclass
class FluxPipelineOutput:
    images: torch.Tensor | None  # (B, H, W, 3) f32 in [0, 1]; None without a VAE
    latents: torch.Tensor  # (B, S, 64) packed, bf16
    cache_hits: int | None = None  # dual-level hits, when a cache ran


class FluxPipeline:
    def __init__(self, transformer, vae=None, text_encoder=None, text_encoder_2=None, tokenizer=None,
                 tokenizer_2=None):
        """``text_encoder``: CLIP (pooled embeddings), ``text_encoder_2``: T5
        (sequence embeddings), each fed by its tokenizer."""
        self.transformer = transformer
        self.vae = vae
        self.text_encoder = text_encoder
        self.text_encoder_2 = text_encoder_2
        self.tokenizer = tokenizer
        self.tokenizer_2 = tokenizer_2

    @torch.no_grad()
    def encode_prompt(self, prompt: str | list[str], max_length: int = 512):
        """-> (prompt_embeds (B, max_length, d_t5), pooled (B, d_clip)): T5 on
        ids of ``max_length`` tokens, CLIP on ids of 77 (JAX :151-163)."""
        if None in (self.text_encoder, self.text_encoder_2, self.tokenizer, self.tokenizer_2):
            raise ValueError("pipeline was built without text encoders; pass prompt_embeds")
        if isinstance(prompt, str):
            prompt = [prompt]
        t5_ids = torch.as_tensor(self.tokenizer_2(prompt, max_length)).to(self.text_encoder_2.embed_tokens.device)
        prompt_embeds = self.text_encoder_2(t5_ids.long())
        clip_ids = torch.as_tensor(self.tokenizer(prompt, CLIP_MAX_LENGTH)).to(self.text_encoder.token_embedding.device)
        pooled, _ = self.text_encoder(clip_ids.long())
        return prompt_embeds, pooled

    @torch.no_grad()
    def __call__(self, prompt: str | list[str] | None = None, prompt_embeds: torch.Tensor | None = None,
                 pooled_prompt_embeds: torch.Tensor | None = None,
                 height: int = 1024, width: int = 1024, num_inference_steps: int = 50,
                 guidance_scale: float = 3.5, seed: int = 0, latents: torch.Tensor | None = None,
                 cache: str | None = None, cache_hit_ratio: float | None = None,
                 residual_diff_threshold: float = 0.12,
                 single_residual_diff_threshold: float = 0.09) -> FluxPipelineOutput:
        """``prompt`` is encoded (:meth:`encode_prompt`) unless
        ``prompt_embeds`` are given. ``cache``: None, ``"fb"`` or
        ``"double_fb"`` (first-block caches, thresholds as in the JAX
        pipeline); ``cache_hit_ratio`` forces a stated hit count
        (:func:`make_hit_schedule`) instead of threshold decisions."""
        if prompt_embeds is None:
            prompt_embeds, pooled_prompt_embeds = self.encode_prompt(prompt)
        if cache not in CACHES:
            raise ValueError(f"cache must be one of {CACHES} (TeaCache is not ported), got {cache!r}")
        if cache_hit_ratio is not None and cache is None:
            raise ValueError("cache_hit_ratio needs an FB cache")
        model = self.transformer
        cfg = model.cfg
        device = prompt_embeds.device
        b, s_txt = prompt_embeds.shape[:2]
        lh, lw = height // 8, width // 8
        s_img = (lh // 2) * (lw // 2)
        if latents is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            noise = torch.randn((b, cfg.out_channels // 4, lh, lw), generator=gen, device=device)
            latents = pack_latents(noise).to(torch.bfloat16)
        img_ids = make_img_ids(lh // 2, lw // 2, device)
        txt_ids = torch.zeros((s_txt, 3), dtype=torch.int32, device=device)
        sigmas = flux_sigmas(num_inference_steps, s_img)
        guidance = (torch.full((b,), guidance_scale, dtype=torch.float32, device=device)
                    if cfg.guidance_embeds else None)
        state = init_fb_state(b, s_img, s_txt, cfg.dim, device) if cache is not None else None
        force = (make_hit_schedule(num_inference_steps, cache_hit_ratio).tolist() if cache_hit_ratio is not None
                 else [None] * num_inference_steps)
        lat = latents.float()
        for i in range(num_inference_steps):
            t = torch.full((b,), float(sigmas[i]), dtype=torch.float32, device=device)
            x = lat.to(torch.bfloat16)
            if state is None:
                vel = model(x, prompt_embeds, pooled_prompt_embeds, t, img_ids, txt_ids, guidance)
            else:
                vel, state = fb_cached_forward(
                    model, state, x, prompt_embeds, pooled_prompt_embeds, t, img_ids, txt_ids, guidance,
                    residual_diff_threshold=residual_diff_threshold,
                    single_residual_diff_threshold=single_residual_diff_threshold if cache == "double_fb" else None,
                    force=force[i])
            lat = euler_step(lat, vel, sigmas[i], sigmas[i + 1])
        latents = lat.to(torch.bfloat16)
        images = None
        if self.vae is not None:
            images = self.vae.decode(unpack_latents(latents, lh, lw))
        return FluxPipelineOutput(images=images, latents=latents,
                                  cache_hits=None if state is None else state.hits)
