"""The port's TeaCache (``caching/teacache.py``, ``FluxPipeline(cache=
"teacache")``) against the JAX package's (CPU), on the tiny FLUX of
tests/test_torch_flux.py at w4a8 in the default configuration, with both
coefficient sets ("flux", and "flux-kontext" over a Kontext request's
reference tokens).

Decisions at the default threshold 0.6: the rescaled distances of these runs
lie 0.23-0.29 a step, so the sums before each decision run 0.25-0.29,
0.49-0.57 (a hit) and 0.74-0.86 (a compute), each at least 0.028 from the
threshold: compute, hit, hit, compute, hit, hit, compute, compute (the last
step always computes), 4 hits of 8. At 0.4 the sums alternate 0.25-0.27
(hit) and 0.50-0.52 (compute): 3 hits of 8.

Tolerances: decisions step by step and hit counts equal JAX's; the
polynomial within 1e-6 of JAX's value (both f32); velocities and latents
within 2e-2 of the reference's max |value| (the FB cache tests' bound,
tests/test_torch_fbcache.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunchaku_tpu.caching import teacache as jtc
from nunchaku_tpu_torch.caching import teacache as ttc
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline
from nunchaku_tpu_torch.pipeline.scheduler import flux_sigmas

from test_torch_flux import _inputs, _rel
from test_torch_flux_conditioning import S_IMG, _cond, _jax, _pair, _port

STEPS = 8
HITS = {0.6: [0, 1, 1, 0, 1, 1, 0, 0], 0.4: [0, 1, 0, 1, 0, 1, 0, 0]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _pair(30)


def test_coefficients_and_poly_match_jax():
    assert ttc.COEFFICIENTS == jtc.COEFFICIENTS
    x = np.array([0.0, 0.05, 0.18, 0.2, 0.5, 1.3], np.float32)
    for name, coeffs in ttc.COEFFICIENTS.items():
        ref = np.asarray(jtc._poly(coeffs, jnp.asarray(x)))
        out = ttc._poly(coeffs, torch.from_numpy(x))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def _steps(jm, tm, model_name, thresh):
    """Both packages' ``teacache_forward`` step by step over the same inputs:
    a latent that drifts each step and the schedule's sigmas. -> (port hit
    flags, JAX hit flags, max velocity error)."""
    lat, txt, pooled, _, ids, tids, g = _inputs()
    sig = flux_sigmas(STEPS, S_IMG)
    jfwd = jax.jit(functools.partial(jtc.teacache_forward, num_steps=STEPS, rel_l1_thresh=thresh,
                                     model_name=model_name))
    jst = jtc.init_teacache_state(1, S_IMG, 256)
    tst = ttc.init_teacache_state(1, S_IMG, 256, device="cpu")
    rng = np.random.default_rng(31)
    flags, jflags, err = [], [], 0.0
    for i in range(STEPS):
        x = np.asarray(jnp.asarray(lat.astype(np.float32) * (1.0 - 0.05 * i)
                                   + 0.05 * rng.standard_normal(lat.shape), jnp.bfloat16))
        t = np.full((1,), sig[i], np.float32)
        ref, new_jst = jfwd(jm, jst, *map(jnp.asarray, (x, txt, pooled, t, ids, tids, g)))
        jflags.append(int(new_jst.hits) - int(jst.hits))
        jst = new_jst
        hits = tst.hits
        with torch.no_grad():
            out, tst = ttc.teacache_forward(tm, tst, *[to_torch(a, "cpu") for a in (x, txt, pooled)],
                                            torch.from_numpy(t), torch.from_numpy(ids), torch.from_numpy(tids),
                                            torch.from_numpy(g), num_steps=STEPS, rel_l1_thresh=thresh,
                                            model_name=model_name)
        flags.append(tst.hits - hits)
        assert tst.step == int(jst.step) == (i + 1) % STEPS
        err = max(err, _rel(out, np.asarray(ref, np.float32)))
    return flags, jflags, err


@pytest.mark.parametrize("model_name", ["flux", "flux-kontext"])
def test_step_decisions_match_jax(pair, model_name):
    """Each step's decision (hit or compute) equals JAX's, the first and
    last steps compute, and each velocity is within the bound."""
    flags, jflags, err = _steps(*pair, model_name, 0.6)
    assert flags == jflags == HITS[0.6]
    assert err <= 2e-2


@pytest.mark.parametrize("thresh", [0.6, 0.4])
def test_pipeline_matches_jax(pair, thresh):
    """``cache="teacache"`` over 8 steps with the "flux" coefficients."""
    jm, tm = pair
    kw = dict(num_inference_steps=STEPS, cache="teacache", teacache_rel_l1_thresh=thresh)
    ref, out = _jax(jm, **kw), _port(tm, **kw)
    assert out.cache_hits == int(ref.cache_hits) == sum(HITS[thresh])
    assert out.latents.shape == (1, S_IMG, 64) and _rel(out.latents, ref.latents) <= 2e-2


def test_kontext_pipeline_matches_jax(pair):
    """The Kontext request with the "flux-kontext" coefficients: the state
    is sized by S_img + S_cond (336 rows), the velocity cut back to S_img."""
    jm, tm = pair
    tok, ids = _cond()
    kw = dict(num_inference_steps=STEPS, cache="teacache", teacache_model_name="flux-kontext", cond_tokens=tok,
              cond_ids=ids)
    ref = _jax(jm, **kw)
    out = _port(tm, **{**kw, "cond_tokens": to_torch(tok, "cpu"), "cond_ids": torch.from_numpy(ids)})
    assert out.cache_hits == int(ref.cache_hits) == sum(HITS[0.6])
    assert _rel(out.latents, ref.latents) <= 2e-2


class _Counting:
    """The model with its block runs counted."""

    def __init__(self, model):
        self.model, self.runs = model, []

    def __getattr__(self, name):
        attr = getattr(self.model, name)
        if name in ("run_dual", "run_singles"):
            def counted(*a, **k):
                self.runs.append(name)
                return attr(*a, **k)
            return counted
        return attr


@pytest.mark.parametrize("thresh,hits", [(1e9, STEPS - 2), (0.0, 0)])
def test_boundary_steps_always_compute(pair, thresh, hits):
    """A threshold no sum reaches hits at every step but the first and the
    last, which compute; a threshold of 0 computes every step. A hit runs no
    block (the embeddings, block 0's norm1 and the head only)."""
    _, tm = pair
    model = _Counting(tm)
    out = _port(model, num_inference_steps=STEPS, cache="teacache", teacache_rel_l1_thresh=thresh)
    assert out.cache_hits == hits
    assert model.runs == ["run_dual", "run_singles"] * (STEPS - hits)
    assert bool(torch.isfinite(out.latents.float()).all())


def test_state_and_refusals(pair):
    _, tm = pair
    st = ttc.init_teacache_state(2, 336, 256, device="cpu")
    assert tuple(st.prev_modulated.shape) == tuple(st.prev_residual.shape) == (2, 336, 256)
    assert st.accumulated.dtype == torch.float32 and st.accumulated.ndim == 0 and (st.step, st.hits) == (0, 0)
    with pytest.raises(ValueError, match="model_name"):
        _port(tm, num_inference_steps=2, cache="teacache", teacache_model_name="sdxl")
    with pytest.raises(ValueError):
        FluxPipeline(tm)(prompt_embeds=torch.zeros((1, 8, 512)), pooled_prompt_embeds=torch.zeros((1, 256)),
                         height=64, width=64, num_inference_steps=2, cache="teacache", cache_hit_ratio=0.5)
