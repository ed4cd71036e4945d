"""First-block cache (FB cache) and double FB cache for the FLUX transformer,
the first-N-blocks cache of Qwen-Image and SANA's first-block cache.

Counterpart of ``nunchaku_tpu/caching/fbcache.py`` (``FBCacheState``,
``init_fb_state``, ``_similar``, ``make_hit_schedule``, ``_apply_force``,
``fb_cached_forward``; ``QwenFBCacheState``, ``init_qwen_fb_state``,
``qwenimage_fb_cached_forward``; ``SanaFBCacheState``, ``init_sana_fb_state``,
``sana_fb_cached_forward``). Each FLUX step runs dual block 0; when its residual is
close (mean relative L1 below the threshold) to the one stored at the last
miss, the cached residual of the remaining dual blocks (and, single-level,
of all single blocks) is added instead of running them. Double FB takes a
second decision of its own at single block 0. Qwen-Image's cache runs its
first ``fn_blocks`` joint blocks (8, the reference's Fn_compute_blocks) as
the indicator, and one decision covers the remaining blocks.

Two differences from the JAX package, which keeps the whole step one
program with ``lax.cond``:

* Decisions are taken on the host. A threshold decision costs one
  ``.item()`` synchronisation; a forced decision (``force`` 0 or 1, from
  :func:`make_hit_schedule`) is known on the host and needs none.
* A miss continues from the indicator's outputs (``run_dual(start=1)``,
  ``run_singles(start=1)``, Qwen's ``run_blocks(start=fn_blocks)``, SANA's
  ``run_blocks(start=1)``) instead
  of rerunning the indicator blocks, which the JAX package does to keep XLA
  from copying a slice of its stacked weights. The values are the same; a
  FLUX miss runs one dual and one single block fewer, a Qwen miss
  ``fn_blocks`` blocks fewer. The blocks are stacks in both packages: the
  port's kernels read layer i by its absolute index into the whole stack,
  where JAX scans a slice of it and counts from 0; the layer read is the
  same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass
class FBCacheState:
    prev_first_residual: torch.Tensor  # (B, S_img, D) bf16, dual block 0's at the last miss
    cached_dual_residual_img: torch.Tensor  # (B, S_img, D) bf16
    cached_dual_residual_txt: torch.Tensor  # (B, S_txt, D) bf16
    prev_single_residual: torch.Tensor  # (B, S, D) bf16, single block 0's at the last miss
    cached_single_residual: torch.Tensor  # (B, S, D) bf16
    valid: bool = False
    hits: int = 0  # dual-level hits


def init_fb_state(batch, s_img, s_txt, dim, device="cuda") -> FBCacheState:
    """Zero bf16 state buffers (residuals feed a mean-relative-L1 test and
    a residual add; bf16 is ample)."""
    def z(s):
        return torch.zeros((batch, s, dim), dtype=torch.bfloat16, device=device)

    return FBCacheState(z(s_img), z(s_img), z(s_txt), z(s_img + s_txt), z(s_img + s_txt))


def _similar(a, b, threshold) -> bool:
    """mean|a-b| / mean|b| < threshold, read back to the host (one sync)."""
    af, bf = a.float(), b.float()
    diff = (af - bf).abs().mean() / (bf.abs().mean() + 1e-8)
    return bool((diff < threshold).item())


def make_hit_schedule(num_steps: int, hit_ratio: float) -> np.ndarray:
    """Forced decisions, one int32 per step: 1 replays the cache, 0
    recomputes. ``round(hit_ratio * num_steps)`` hits spread evenly over
    steps 1..N-1 (step 0 must miss: the cache is empty). Every hit costs the
    same, so a stated hit count makes a cached run's time auditable where
    random weights would make threshold decisions meaningless."""
    h = int(round(hit_ratio * num_steps))
    h = max(0, min(h, num_steps - 1))
    sched = np.zeros((num_steps,), np.int32)
    if h:
        idx = np.round(np.linspace(1, num_steps - 1, h)).astype(np.int64)
        seen, fixed = set(), []
        for i in idx:  # dedupe while keeping the count exact
            while i in seen or i < 1:
                i += 1
            seen.add(i)
            fixed.append(i)
        sched[np.asarray(fixed, np.int64)] = 1
    return sched


def _apply_force(natural: Callable[[], bool], force) -> bool:
    """``force`` None or < 0 takes the threshold decision (``natural()``,
    evaluated only then); 0 or 1 overrides it."""
    if force is None or force < 0:
        return natural()
    return force > 0


def fb_cached_forward(model, state: FBCacheState, hidden_states, encoder_hidden_states, pooled_projections,
                      timestep, img_ids, txt_ids, guidance=None, *, residual_diff_threshold: float = 0.12,
                      single_residual_diff_threshold: float | None = None, force=None):
    """One cached transformer step -> (velocity, new state).

    ``single_residual_diff_threshold`` turns on double FB; None keeps the
    single-level scheme (the singles are cached with the duals). ``force``:
    None or < 0 threshold decisions, 0 force a miss, 1 force a hit (both
    levels). A hit needs a valid state (step 0 always misses)."""
    img0, txt0, temb, rot = model.embed(hidden_states, encoder_hidden_states, pooled_projections, timestep,
                                        img_ids, txt_ids, guidance)
    s_txt = txt0.shape[1]
    img1, txt1 = model.run_dual(img0, txt0, temb, rot, start=0, stop=1)
    first_res = (img1 - img0).to(torch.bfloat16)
    hit = state.valid and _apply_force(
        lambda: _similar(first_res, state.prev_first_residual, residual_diff_threshold), force)

    if hit:
        dual_res_img, dual_res_txt = state.cached_dual_residual_img, state.cached_dual_residual_txt
        img_f, txt_f = img1 + dual_res_img, txt1 + dual_res_txt
    else:
        img_f, txt_f = model.run_dual(img1, txt1, temb, rot, start=1)
        dual_res_img, dual_res_txt = (img_f - img1).to(torch.bfloat16), (txt_f - txt1).to(torch.bfloat16)
    x1 = torch.cat([txt_f, img_f], dim=1)

    prev_sres = state.prev_single_residual
    if single_residual_diff_threshold is None:
        if hit:
            cached_sres = state.cached_single_residual
            x_f = x1 + cached_sres
        else:
            x_f = model.run_singles(x1, temb, rot)
            cached_sres = (x_f - x1).to(torch.bfloat16)
    else:
        x2 = model.run_singles(x1, temb, rot, start=0, stop=1)
        sres = (x2 - x1).to(torch.bfloat16)
        shit = state.valid and _apply_force(
            lambda: _similar(sres, state.prev_single_residual, single_residual_diff_threshold), force)
        if shit:
            cached_sres = state.cached_single_residual
            x_f = x2 + cached_sres
        else:
            x_f = model.run_singles(x2, temb, rot, start=1)
            cached_sres = (x_f - x2).to(torch.bfloat16)
            # store-on-miss: hits keep comparing against the last miss's
            # residual, so drift below the threshold still forces a recompute
            prev_sres = sres

    out = model.head(x_f[:, s_txt:], temb)
    new_state = FBCacheState(
        prev_first_residual=state.prev_first_residual if hit else first_res,
        cached_dual_residual_img=dual_res_img,
        cached_dual_residual_txt=dual_res_txt,
        prev_single_residual=prev_sres,
        cached_single_residual=cached_sres,
        valid=True,
        hits=state.hits + int(hit),
    )
    return out, new_state


@dataclass
class QwenFBCacheState:
    prev_first_residual: torch.Tensor  # (B, S_img, D) bf16, the indicator blocks' at the last miss
    cached_rest_residual: torch.Tensor  # (B, S_img, D) bf16, the remaining blocks'
    valid: bool = False
    hits: int = 0


def init_qwen_fb_state(batch, s_img, dim, device="cuda") -> QwenFBCacheState:
    def z():
        return torch.zeros((batch, s_img, dim), dtype=torch.bfloat16, device=device)

    return QwenFBCacheState(z(), z())


def qwenimage_fb_cached_forward(model, state: QwenFBCacheState, hidden_states, encoder_hidden_states, timestep,
                                img_ids, txt_ids=None, *, residual_diff_threshold: float = 0.12,
                                fn_blocks: int = 8, encoder_hidden_states_mask=None, force=None):
    """One cached Qwen-Image step -> (velocity, new state).

    Blocks [0, fn) are the indicator (fn = ``fn_blocks`` within [1, L - 1]);
    their image-stream residual is compared with the one stored at the last
    miss. A hit adds the cached residual of blocks [fn, L) instead of running
    them; the text stream is only an intermediate, so a hit needs none of
    it. ``force``: None or < 0 threshold decision, 0 force a miss, 1 force a
    hit (a hit needs a valid state: step 0 always misses)."""
    fn = max(1, min(int(fn_blocks), model.cfg.num_layers - 1))
    img0, txt0, temb, rot = model.embed(hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids)
    kv_mask = model.kv_mask_for(img0, encoder_hidden_states_mask)
    img1, txt1 = model.run_blocks(img0, txt0, temb, rot, start=0, stop=fn, kv_mask=kv_mask)
    first_res = (img1 - img0).to(torch.bfloat16)
    hit = state.valid and _apply_force(
        lambda: _similar(first_res, state.prev_first_residual, residual_diff_threshold), force)
    if hit:
        rest = state.cached_rest_residual
        img_f = img1 + rest
    else:
        img_f, _ = model.run_blocks(img1, txt1, temb, rot, start=fn, kv_mask=kv_mask)
        rest = (img_f - img1).to(torch.bfloat16)
    new_state = QwenFBCacheState(
        # store-on-miss: hits keep comparing against the last miss's residual
        prev_first_residual=state.prev_first_residual if hit else first_res,
        cached_rest_residual=rest, valid=True, hits=state.hits + int(hit))
    return model.head(img_f, temb), new_state


@dataclass
class SanaFBCacheState:
    prev_first_residual: torch.Tensor  # (B, S_img, D) bf16, block 0's at the last miss
    cached_rest_residual: torch.Tensor  # (B, S_img, D) bf16, blocks 1..L-1's
    valid: bool = False
    hits: int = 0


def init_sana_fb_state(batch, s_img, dim, device="cuda") -> SanaFBCacheState:
    def z():
        return torch.zeros((batch, s_img, dim), dtype=torch.bfloat16, device=device)

    return SanaFBCacheState(z(), z())


def sana_fb_cached_forward(model, state: SanaFBCacheState, hidden_states, encoder_hidden_states, timestep,
                           cond_mask=None, pag: bool = False, *, residual_diff_threshold: float = 0.12):
    """One cached SANA step -> (velocity, new state) (JAX :355-419): block 0
    runs; when its residual is close to the one stored at the last miss, the
    cached residual of blocks 1..L-1 is added instead of running them."""
    x0, cond, temb, temb6, side = model.embed(hidden_states, encoder_hidden_states, timestep)
    x1 = model.run_blocks(x0, cond, temb6, side, cond_mask, pag, start=0, stop=1)
    first_res = (x1 - x0).to(torch.bfloat16)
    hit = state.valid and _similar(first_res, state.prev_first_residual, residual_diff_threshold)
    if hit:
        rest = state.cached_rest_residual
        x = x1 + rest.float()
    else:
        x = model.run_blocks(x1, cond, temb6, side, cond_mask, pag, start=1)
        rest = (x - x1).to(torch.bfloat16)
    new_state = SanaFBCacheState(
        # store-on-miss: hits keep comparing against the last miss's residual
        prev_first_residual=state.prev_first_residual if hit else first_res,
        cached_rest_residual=rest, valid=True, hits=state.hits + int(hit))
    return model.head(x, temb), new_state
