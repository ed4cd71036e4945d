"""Qwen-Image text-to-image pipeline (counterpart of
``nunchaku_tpu/pipeline/pipeline_qwenimage.py`` ``QwenImagePipeline`` for
prompt embeddings): the flow-match Euler schedule, true classifier-free
guidance (two transformer forwards a step, one per prompt branch, each with
its own padded-prompt mask), the Lightning presets, the first-N-blocks
cache ``"fb"`` (one state per branch), Qwen-Image-Edit conditioning and an
optional VAE decode. The denoise loop is a Python loop.

Edit conditioning follows the QwenEmbedRope contract: each reference image
is VAE-encoded, packed and appended to the image tokens with rope frame
index i + 1 (the generated image is frame 0); only the first S_img velocity
rows integrate. Edit-2509 passes several images (frames 1..N). ControlNet
(``control_image=``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..caching.fbcache import init_qwen_fb_state, qwenimage_fb_cached_forward
from .pipeline_flux import image_tokens, make_img_ids, pack_latents, unpack_latents
from .scheduler import euler_step, flux_sigmas

# Lightning-distilled checkpoints: fixed few-step recipes
LIGHTNING_PRESETS = {
    "lightning-4step": dict(num_inference_steps=4, true_cfg_scale=1.0),
    "lightning-8step": dict(num_inference_steps=8, true_cfg_scale=1.0),
}


@dataclass
class QwenImagePipelineOutput:
    images: torch.Tensor | None  # (B, H, W, 3) f32 in [0, 1]; None without a VAE
    latents: torch.Tensor  # (B, S_img, 64) packed, bf16
    cache_hits: int | None = None  # both branches' hits summed, when the cache ran


class QwenImagePipeline:
    def __init__(self, transformer, vae=None):
        self.transformer = transformer
        self.vae = vae

    def prepare_edit(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """Edit reference image(s) -> (tokens (B, S_cond, 64) bf16, ids
        (S_cond, 3)): one (B, H, W, 3) tensor in [0, 1] or a list of them
        (Edit-2509), each cast to bf16, encoded to the VAE's mode and packed;
        image i takes rope frame index i + 1."""
        if self.vae is None or self.vae.encoder is None:
            raise ValueError("edit conditioning needs a VAE with an encoder")
        if not isinstance(images, (list, tuple)):
            images = [images]
        toks, ids = [], []
        for i, im in enumerate(images):
            toks.append(image_tokens(self.vae, im))
            frame = make_img_ids(im.shape[1] // 16, im.shape[2] // 16, toks[-1].device)
            frame[:, 0] = i + 1
            ids.append(frame)
        return torch.cat(toks, dim=1), torch.cat(ids, dim=0)

    @torch.no_grad()
    def __call__(self, prompt_embeds: torch.Tensor, negative_prompt_embeds: torch.Tensor | None = None,
                 prompt_embeds_mask: torch.Tensor | None = None,
                 negative_prompt_embeds_mask: torch.Tensor | None = None, height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 20, true_cfg_scale: float = 4.0, seed: int = 0,
                 latents: torch.Tensor | None = None, lightning: str | None = None, image=None,
                 cond_tokens: torch.Tensor | None = None, cond_ids: torch.Tensor | None = None,
                 control_image=None, cache: str | None = None,
                 residual_diff_threshold: float = 0.12, fn_blocks: int = 8) -> QwenImagePipelineOutput:
        """``prompt_embeds`` (B, S_txt, joint_dim) with an optional (B, S_txt)
        bool ``prompt_embeds_mask`` (padded prompts); guidance runs when
        ``negative_prompt_embeds`` is given and ``true_cfg_scale`` > 1, and
        then needs masks on both branches or neither. ``lightning`` names a
        preset that sets the steps and the guidance scale. ``cache="fb"``
        runs the first ``fn_blocks`` blocks as the cache's indicator.
        ``image``: edit reference(s) for :meth:`prepare_edit`, or their
        ``cond_tokens`` (B or 1, S_cond, 64) with ``cond_ids`` (S_cond, 3),
        appended to the image tokens (broadcast to B)."""
        if control_image is not None:
            raise NotImplementedError("ControlNet (control_image=) is not ported")
        if cache not in (None, "fb"):
            raise ValueError(f"qwen cache supports 'fb', got {cache!r}")
        if lightning is not None:
            preset = LIGHTNING_PRESETS[lightning]
            num_inference_steps = preset["num_inference_steps"]
            true_cfg_scale = preset["true_cfg_scale"]
        model = self.transformer
        cfg = model.cfg
        device = prompt_embeds.device
        b = prompt_embeds.shape[0]
        lh, lw = height // 8, width // 8
        s_img = (lh // 2) * (lw // 2)
        if latents is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            noise = torch.randn((b, cfg.in_channels // 4, lh, lw), generator=gen, device=device)
            latents = pack_latents(noise).to(torch.bfloat16)
        img_ids = make_img_ids(lh // 2, lw // 2, device)
        if image is not None:
            cond_tokens, cond_ids = self.prepare_edit(image)
        s_cond = 0
        if cond_tokens is not None:
            if cond_ids is None:
                raise ValueError("cond_tokens need their cond_ids")
            img_ids = torch.cat([img_ids, cond_ids.to(device=device, dtype=img_ids.dtype)], dim=0)
            cond_tokens = cond_tokens.to(device=device, dtype=torch.bfloat16)
            if cond_tokens.shape[0] < b:
                cond_tokens = cond_tokens.expand(b, *cond_tokens.shape[1:])
            s_cond = cond_tokens.shape[1]
        sigmas = flux_sigmas(num_inference_steps, s_img)
        use_cfg = negative_prompt_embeds is not None and true_cfg_scale > 1.0
        branches = [(prompt_embeds, prompt_embeds_mask)]
        if use_cfg:
            branches.append((negative_prompt_embeds, negative_prompt_embeds_mask))
            if (prompt_embeds_mask is None) != (negative_prompt_embeds_mask is None):
                raise ValueError("pass masks for both prompt branches or neither")
        states = ([init_qwen_fb_state(b, s_img + s_cond, cfg.dim, device) for _ in branches] if cache is not None
                  else None)
        lat = latents.float()
        for i in range(num_inference_steps):
            t = torch.full((b,), float(sigmas[i]), dtype=torch.float32, device=device)
            x = lat.to(torch.bfloat16)
            if s_cond:
                x = torch.cat([x, cond_tokens], dim=1)
            vels = []
            for j, (embeds, mask) in enumerate(branches):
                if states is None:
                    vels.append(model(x, embeds, t, img_ids, encoder_hidden_states_mask=mask)[:, :s_img])
                else:
                    vel, states[j] = qwenimage_fb_cached_forward(
                        model, states[j], x, embeds, t, img_ids, residual_diff_threshold=residual_diff_threshold,
                        fn_blocks=fn_blocks, encoder_hidden_states_mask=mask)
                    vels.append(vel[:, :s_img])
            vel = vels[0] if not use_cfg else vels[1] + true_cfg_scale * (vels[0] - vels[1])
            lat = euler_step(lat, vel, sigmas[i], sigmas[i + 1])
        latents = lat.to(torch.bfloat16)
        images = None
        if self.vae is not None:
            images = self.vae.decode(unpack_latents(latents, lh, lw))
        return QwenImagePipelineOutput(images=images, latents=latents,
                                       cache_hits=None if states is None else sum(st.hits for st in states))
