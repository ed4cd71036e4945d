"""Flow-matching Euler scheduler of the FLUX family (counterpart of
``nunchaku_tpu/pipeline/scheduler.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch


def compute_shift_mu(image_seq_len: int) -> float:
    """FLUX dynamic-shift mu (diffusers calculate_shift: 0.5 at 256 tokens,
    1.15 at 4096, linear between)."""
    m = (1.15 - 0.5) / (4096 - 256)
    b = 0.5 - m * 256
    return image_seq_len * m + b


def flux_sigmas(num_steps: int, image_seq_len: int | None = None, *, shift: float = 1.0,
                use_dynamic_shifting: bool = True) -> np.ndarray:
    """Sigma schedule (num_steps + 1,) f32, ending at 0: dynamically shifted
    for the image's token count (FLUX, Qwen-Image), or, with
    ``use_dynamic_shifting=False`` or no token count, by the constant
    ``shift`` (``shift * s / (1 + (shift - 1) * s)``; SANA: 3.0)."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting and image_seq_len is not None:
        mu = compute_shift_mu(image_seq_len)
        sigmas = math.e**mu / (math.e**mu + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def euler_step(latents: torch.Tensor, velocity: torch.Tensor, sigma, sigma_next) -> torch.Tensor:
    """``latents + (sigma_next - sigma) * velocity``, the step size taken in f32."""
    dt = float(np.float32(sigma_next) - np.float32(sigma))
    return latents + dt * velocity.to(latents.dtype)
