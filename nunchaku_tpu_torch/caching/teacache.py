"""TeaCache: timestep-embedding-aware step caching for the FLUX transformer.

Counterpart of ``nunchaku_tpu/caching/teacache.py`` (``COEFFICIENTS``,
``TeaCacheState``, ``init_teacache_state``, ``_poly``, ``teacache_forward``).
Each step runs the embeddings and dual block 0's ``norm1`` (AdaLN) alone;
the mean relative L1 distance of its modulated output from the previous
step's, rescaled by a model-specific polynomial, accumulates across steps.
While the sum stays under the threshold the blocks are skipped and the
image stream's residual stored at the last computed step is added instead;
the output head always runs with the current step's embedding. The first and
last steps always compute.

Where the JAX package keeps the step one program (``lax.cond``), the
decision is taken on the host: the distance and the sum are f32 tensors on
the model's device as in JAX, and one ``.item()`` a step reads the decision
(none on the first and last steps, which compute whatever the sum).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

COEFFICIENTS = {
    # polynomial rescale, highest power first
    "flux": (4.98651651e02, -2.83781631e02, 5.58554382e01, -3.82021401e00, 2.64230861e-01),
    "flux-kontext": (-1.04655119e03, 3.12563399e02, -1.69500694e01, 4.10995971e-01, 3.74537863e-02),
}


@dataclass
class TeaCacheState:
    prev_modulated: torch.Tensor  # (B, S_img, D) bf16, block 0's norm1 output at the last step
    prev_residual: torch.Tensor  # (B, S_img, D) bf16, the blocks' image-stream residual at the last computed step
    accumulated: torch.Tensor  # () f32, on the model's device
    step: int = 0
    hits: int = 0


def init_teacache_state(batch, s_img, dim, device="cuda") -> TeaCacheState:
    def z():
        return torch.zeros((batch, s_img, dim), dtype=torch.bfloat16, device=device)

    return TeaCacheState(z(), z(), torch.zeros((), dtype=torch.float32, device=device))


def _poly(coeffs, x):
    """Horner's rule in x's dtype (f32), highest power first."""
    acc = torch.zeros_like(x)
    for c in coeffs:
        acc = acc * x + c
    return acc


def teacache_forward(model, state: TeaCacheState, hidden_states, encoder_hidden_states, pooled_projections,
                     timestep, img_ids, txt_ids, guidance=None, *, num_steps: int, rel_l1_thresh: float = 0.6,
                     model_name: str = "flux"):
    """One TeaCache step -> (velocity, new state). ``num_steps`` is the
    request's step count (its first and last steps compute);
    ``model_name`` picks the rescale polynomial (``COEFFICIENTS``)."""
    if model_name not in COEFFICIENTS:
        raise ValueError(f"teacache model_name must be one of {sorted(COEFFICIENTS)}, got {model_name!r}")
    img0, txt0, temb, rot = model.embed(hidden_states, encoder_hidden_states, pooled_projections, timestep,
                                        img_ids, txt_ids, guidance)
    s_txt = txt0.shape[1]
    # dual block 0's AdaLN through its stacked layer view (the decision's only block work)
    modulated = model.layer_views()["transformer_blocks"][0].norm1(img0, temb)[0].to(torch.bfloat16)
    prev = state.prev_modulated.float()
    rel = (modulated.float() - prev).abs().mean() / (prev.abs().mean() + 1e-8)
    acc = state.accumulated + _poly(COEFFICIENTS[model_name], rel).abs()
    boundary = state.step == 0 or state.step == num_steps - 1
    should_calc = boundary or bool((acc >= rel_l1_thresh).item())
    if should_calc:
        acc = torch.zeros_like(acc)
        img, txt = model.run_dual(img0, txt0, temb, rot)
        img_f = model.run_singles(torch.cat([txt, img], dim=1), temb, rot)[:, s_txt:]
        resid = (img_f - img0).to(torch.bfloat16)  # the blocks' image-stream residual
    else:
        resid = state.prev_residual
    out = model.head(img0 + resid, temb)
    return out, TeaCacheState(prev_modulated=modulated, prev_residual=resid, accumulated=acc,
                              step=(state.step + 1) % num_steps, hits=state.hits + int(not should_calc))
