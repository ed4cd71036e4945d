"""SANA text-to-image pipeline (counterpart of
``nunchaku_tpu/pipeline/pipeline_sana.py``): a prompt through a tokenizer
callable ``tok(prompts, 300) -> ids`` and the text encoder (Gemma-2), or
prompt embeddings; flow-matching Euler with the constant shift 3.0;
classifier-free guidance against zero embeddings (B 2), perturbed-attention
guidance (batch [uncond, text, text_perturbed], the perturbed rows taking
the value projection alone on ``cfg.pag_layers``), the first-block cache
``"fb"``, and a DC-AE decode of the latents divided by the autoencoder's
scaling factor. Latent tokens are (B, (H/32) * (W/32), 32), patch size 1.

As in JAX: the unconditional branch is zero embeddings (not an encoded
empty prompt), and the text encoder gets no attention mask. The default
noise comes from a ``torch.Generator``, not ``jax.random``; parity runs
pass ``latents``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..caching.fbcache import init_sana_fb_state, sana_fb_cached_forward
from .scheduler import euler_step, flux_sigmas

TEXT_LEN = 300  # every prompt is padded to 300 tokens
SHIFT = 3.0


@dataclass
class SanaPipelineOutput:
    images: torch.Tensor | None  # (B, H, W, 3) f32 in [0, 1]; None without an autoencoder
    latents: torch.Tensor  # (B, C, h, w) f32


class SanaPipeline:
    def __init__(self, transformer, vae=None, text_encoder=None, tokenizer=None):
        self.transformer = transformer
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer

    @torch.no_grad()
    def __call__(self, prompt=None, prompt_embeds: torch.Tensor | None = None,
                 prompt_attention_mask: torch.Tensor | None = None, height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 20, guidance_scale: float = 4.5, pag_scale: float = 0.0, seed: int = 0,
                 latents: torch.Tensor | None = None, cache: str | None = None,
                 residual_diff_threshold: float = 0.12) -> SanaPipelineOutput:
        """``prompt_attention_mask`` (B, S_txt) bool reaches the
        cross-attention (the masked softmax); guidance runs when
        ``guidance_scale`` > 1, PAG when ``pag_scale`` > 0 (a PAG checkpoint:
        ``cfg.pag_layers`` set); ``cache="fb"`` only unguided, without PAG."""
        if prompt_embeds is None:
            if self.text_encoder is None:
                raise ValueError("pass prompt_embeds or build with a text encoder")
            ids = self.tokenizer([prompt] if isinstance(prompt, str) else prompt, TEXT_LEN)
            prompt_embeds = self.text_encoder(ids)
        model = self.transformer
        cfg = model.cfg
        device = prompt_embeds.device
        b = prompt_embeds.shape[0]
        lh, lw = height // 32, width // 32  # DC-AE's 32x stride
        s_img = lh * lw
        if latents is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            latents = torch.randn((b, s_img, cfg.in_channels), generator=gen, device=device)
        sigmas = flux_sigmas(num_inference_steps, use_dynamic_shifting=False, shift=SHIFT)
        use_cfg = guidance_scale > 1.0
        use_pag = pag_scale > 0.0
        if cache not in (None, "fb"):
            raise ValueError(f"SANA supports cache=None or 'fb', got {cache!r}")
        if cache == "fb" and use_pag:
            raise ValueError("cache='fb' with PAG is unsupported (as in the reference: cached SANA blocks have no "
                             "pag path)")
        if cache == "fb" and use_cfg:
            raise ValueError("cache='fb' with guidance_scale>1 is unsupported")
        pag_layers = cfg.pag_layers
        if use_pag and pag_layers is None:
            raise ValueError("pag_scale > 0 needs a PAG checkpoint (pag_to_v projections; cfg.pag_layers is set by "
                             "the loader / SanaConfig)")

        mask = prompt_attention_mask
        zeros = torch.zeros_like(prompt_embeds)
        if use_pag:
            reps = 3 if use_cfg else 2
            pe_n = torch.cat(([zeros] if use_cfg else []) + [prompt_embeds, prompt_embeds])
            rows = torch.arange(reps * b, device=device) >= (reps - 1) * b
        elif use_cfg:
            reps, pe_n = 2, torch.cat([zeros, prompt_embeds])
        else:
            reps, pe_n = 1, prompt_embeds
        mask_n = None if mask is None else torch.cat([mask] * reps)
        state = init_sana_fb_state(b, s_img, cfg.dim, device) if cache == "fb" else None

        lat = latents.float()
        for i in range(num_inference_steps):
            t = torch.full((b * reps,), float(sigmas[i]), dtype=torch.float32, device=device)
            x = torch.cat([lat] * reps).to(torch.bfloat16)
            if state is not None:
                vel, state = sana_fb_cached_forward(model, state, x, pe_n, t, cond_mask=mask_n,
                                                    residual_diff_threshold=residual_diff_threshold)
                vel = vel.float()
            elif use_pag:
                v = model(x, pe_n, t, cond_mask=mask_n, pag=True, pag_layers=pag_layers, pag_rows=rows).float()
                if use_cfg:
                    v_unc, v_txt, v_ptb = v.chunk(3)
                    vel = v_unc + guidance_scale * (v_txt - v_unc) + pag_scale * (v_txt - v_ptb)
                else:
                    v_txt, v_ptb = v.chunk(2)
                    vel = v_txt + pag_scale * (v_txt - v_ptb)
            elif use_cfg:
                v_unc, v_txt = model(x, pe_n, t, cond_mask=mask_n).float().chunk(2)
                vel = v_unc + guidance_scale * (v_txt - v_unc)
            else:
                vel = model(x, pe_n, t, cond_mask=mask_n).float()
            lat = euler_step(lat, vel, sigmas[i], sigmas[i + 1])

        z = lat.reshape(b, lh, lw, cfg.out_channels).permute(0, 3, 1, 2)
        images = None
        if self.vae is not None:
            sf = getattr(getattr(self.vae, "cfg", None), "scaling_factor", None)
            images = self.vae.decode((z / sf if sf else z).to(torch.bfloat16))
        return SanaPipelineOutput(images=images, latents=z)
