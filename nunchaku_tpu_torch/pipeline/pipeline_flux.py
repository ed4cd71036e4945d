"""FLUX pipeline (counterpart of ``nunchaku_tpu/pipeline/pipeline_flux.py``):
text-to-image from a prompt or its embeddings, image-conditioned requests
(FLUX.1-Kontext reference images on the sequence axis, FLUX.1-Fill masked
images and Canny / Depth control latents on the channel axis), the
first-block caches ``"fb"`` and ``"double_fb"`` and TeaCache, and an
optional VAE. A prompt is encoded from token ids by the T5 (sequence) and
CLIP (pooled) encoders, each behind a tokenizer: any callable
``tokenizer(prompts, max_length) -> (B, max_length) ids``, as in JAX. The
denoise loop is a Python loop of transformer forwards (cached or not) and
Euler steps, the JAX package's scanned loop (``_denoise_scanned``) step for
step; with a VAE the latents are decoded to images.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..caching.fbcache import fb_cached_forward, init_fb_state, make_hit_schedule
from ..caching.teacache import init_teacache_state, teacache_forward
from .scheduler import euler_step, flux_sigmas

CACHES = (None, "fb", "double_fb", "teacache")
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


def image_tokens(vae, image) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> packed latent tokens (B, H/16 * W/16, 64)
    bf16: the image cast to bf16 on the VAE's device, the encoder's mode,
    2x2-patchified (the FLUX and Qwen-Image pipelines' conditioning)."""
    device = next(vae.buffers()).device
    return pack_latents(vae.encode(torch.as_tensor(image).to(device=device, dtype=torch.bfloat16))).to(torch.bfloat16)


def make_img_ids(h_tokens: int, w_tokens: int, device="cpu") -> torch.Tensor:
    ids = np.zeros((h_tokens * w_tokens, 3), np.int32)
    ids[:, 1] = np.repeat(np.arange(h_tokens), w_tokens)
    ids[:, 2] = np.tile(np.arange(w_tokens), h_tokens)
    return torch.from_numpy(ids).to(device)


@dataclass
class FluxPipelineOutput:
    images: torch.Tensor | None  # (B, H, W, 3) f32 in [0, 1]; None without a VAE
    latents: torch.Tensor  # (B, S, 64) packed, bf16
    cache_hits: int | None = None  # dual-level (FB) or skipped-step (TeaCache) hits, when a cache ran


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

    # -- conditioning (the FLUX variants) ------------------------------------
    def encode_image_tokens(self, image) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> packed latent tokens (B, H/16 * W/16, 64)
        bf16 (:func:`image_tokens`)."""
        if self.vae is None or self.vae.encoder is None:
            raise ValueError("image conditioning needs a VAE with an encoder")
        return image_tokens(self.vae, image)

    def prepare_kontext(self, image):
        """FLUX.1-Kontext reference image -> (tokens, ids): the tokens ride
        the sequence axis with rope frame index 1 (the model attends to them;
        only the first S_img velocity rows integrate)."""
        tokens = self.encode_image_tokens(image)
        ids = make_img_ids(image.shape[1] // 16, image.shape[2] // 16, tokens.device)
        ids[:, 0] = 1
        return tokens, ids

    def prepare_control(self, control_image) -> torch.Tensor:
        """FLUX.1 Canny / Depth conditioning: the encoded control image packed
        to (B, S_img, 64), concatenated on the channel axis each step
        (``in_channels`` 128)."""
        return self.encode_image_tokens(control_image)

    def prepare_fill(self, image, mask) -> torch.Tensor:
        """FLUX.1-Fill conditioning (``in_channels`` 384): the masked image's
        tokens (64 channels) and the binary mask 8x8-patchified to 64
        channels, then 2x2 to 256 -> (B, S, 320) bf16.

        image (B, H, W, 3) in [0, 1]; mask (B, H, W), 1 = inpaint."""
        image, mask = torch.as_tensor(image), torch.as_tensor(mask)
        b, h, w = mask.shape
        img_tok = self.encode_image_tokens(image * (1.0 - mask[..., None]))
        m = mask.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h // 8, w // 8, 64)
        m = m.reshape(b, h // 16, 2, w // 16, 2, 64).permute(0, 1, 3, 2, 4, 5)
        m = m.reshape(b, (h // 16) * (w // 16), 256)
        return torch.cat([img_tok, m.to(device=img_tok.device, dtype=torch.bfloat16)], dim=-1)

    @torch.no_grad()
    def __call__(self, prompt: str | list[str] | None = None, prompt_embeds: torch.Tensor | None = None,
                 pooled_prompt_embeds: torch.Tensor | None = None,
                 height: int = 1024, width: int = 1024, num_inference_steps: int = 50,
                 guidance_scale: float = 3.5, seed: int = 0, latents: torch.Tensor | None = None,
                 cache: str | None = None, cache_hit_ratio: float | None = None,
                 residual_diff_threshold: float = 0.12,
                 single_residual_diff_threshold: float = 0.09, teacache_rel_l1_thresh: float = 0.6,
                 teacache_model_name: str = "flux", image=None, cond_tokens: torch.Tensor | None = None,
                 cond_ids: torch.Tensor | None = None,
                 control_latents: torch.Tensor | None = None) -> FluxPipelineOutput:
        """``prompt`` is encoded (:meth:`encode_prompt`) unless
        ``prompt_embeds`` are given. ``cache``: None, ``"fb"`` or
        ``"double_fb"`` (first-block caches, thresholds as in the JAX
        pipeline; ``cache_hit_ratio`` forces a stated hit count,
        :func:`make_hit_schedule`, instead of threshold decisions) or
        ``"teacache"`` (``teacache_rel_l1_thresh``, ``teacache_model_name``
        ``"flux"`` or ``"flux-kontext"``).

        Conditioning: ``image`` (B, H, W, 3) in [0, 1], a Kontext reference
        encoded by :meth:`prepare_kontext`, or its ``cond_tokens`` (B, S_cond,
        64) with ``cond_ids`` (S_cond, 3), appended on the sequence axis;
        ``control_latents`` (B, S_img, C), from :meth:`prepare_control` or
        :meth:`prepare_fill`, appended on the channel axis (the model's
        ``in_channels`` = 64 + C). The noise keeps ``out_channels // 4``
        channels and the schedule the output's token count."""
        if prompt_embeds is None:
            prompt_embeds, pooled_prompt_embeds = self.encode_prompt(prompt)
        if cache not in CACHES:
            raise ValueError(f"cache must be one of {CACHES}, got {cache!r}")
        if cache_hit_ratio is not None and cache not in ("fb", "double_fb"):
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
            # the noise is the 16-channel image latent; conditioning channels come from control_latents
            noise = torch.randn((b, cfg.out_channels // 4, lh, lw), generator=gen, device=device)
            latents = pack_latents(noise).to(torch.bfloat16)
        if image is not None:
            cond_tokens, cond_ids = self.prepare_kontext(image)
        img_ids = make_img_ids(lh // 2, lw // 2, device)
        txt_ids = torch.zeros((s_txt, 3), dtype=torch.int32, device=device)
        s_model = s_img
        if cond_tokens is not None:
            if cond_ids is None:
                raise ValueError("cond_tokens need their cond_ids")
            img_ids = torch.cat([img_ids, cond_ids.to(device=device, dtype=img_ids.dtype)], dim=0)
            s_model = s_img + cond_tokens.shape[1]
            cond_tokens = cond_tokens.to(device=device, dtype=torch.bfloat16)
        if control_latents is not None:
            control_latents = control_latents.to(device=device, dtype=torch.bfloat16)
        sigmas = flux_sigmas(num_inference_steps, s_img)
        guidance = (torch.full((b,), guidance_scale, dtype=torch.float32, device=device)
                    if cfg.guidance_embeds else None)
        if cache in ("fb", "double_fb"):
            state = init_fb_state(b, s_model, s_txt, cfg.dim, device)
        elif cache == "teacache":
            state = init_teacache_state(b, s_model, cfg.dim, device)
        else:
            state = None
        force = (make_hit_schedule(num_inference_steps, cache_hit_ratio).tolist() if cache_hit_ratio is not None
                 else [None] * num_inference_steps)
        lat = latents.float()
        for i in range(num_inference_steps):
            t = torch.full((b,), float(sigmas[i]), dtype=torch.float32, device=device)
            x = lat.to(torch.bfloat16)
            if control_latents is not None:
                x = torch.cat([x, control_latents], dim=-1)
            if cond_tokens is not None:
                x = torch.cat([x, cond_tokens], dim=1)
            args = (x, prompt_embeds, pooled_prompt_embeds, t, img_ids, txt_ids, guidance)
            if state is None:
                vel = model(*args)
            elif cache == "teacache":
                vel, state = teacache_forward(model, state, *args, num_steps=num_inference_steps,
                                              rel_l1_thresh=teacache_rel_l1_thresh, model_name=teacache_model_name)
            else:
                vel, state = fb_cached_forward(
                    model, state, *args, residual_diff_threshold=residual_diff_threshold,
                    single_residual_diff_threshold=single_residual_diff_threshold if cache == "double_fb" else None,
                    force=force[i])
            lat = euler_step(lat, vel[:, :s_img], sigmas[i], sigmas[i + 1])
        latents = lat.to(torch.bfloat16)
        images = None
        if self.vae is not None:
            images = self.vae.decode(unpack_latents(latents, lh, lw))
        return FluxPipelineOutput(images=images, latents=latents,
                                  cache_hits=None if state is None else state.hits)


def apply_cache_on_pipe(pipe: FluxPipeline, **kwargs) -> FluxPipeline:
    """The reference API's cache switch, as the JAX package has it: sets
    ``pipe.default_cache`` (``"double_fb"`` when ``use_double_fb_cache``,
    else ``"fb"``) and ``pipe.default_thresholds`` (the residual and single
    residual thresholds, 0.12 and 0.09 unless given). Nothing reads these
    attributes, in either package: the cache is chosen per call through
    ``pipe(..., cache=...)``."""
    pipe.default_cache = "double_fb" if kwargs.get("use_double_fb_cache", False) else "fb"
    pipe.default_thresholds = (kwargs.get("residual_diff_threshold", 0.12),
                               kwargs.get("single_residual_diff_threshold", 0.09))
    return pipe
