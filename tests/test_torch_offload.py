"""Block offloading of the port (``utils.offload``) on the CPU: the four
offloaded forwards against the port's resident forwards (FLUX 2 + 2 blocks
at int4 and w4a8, Qwen-Image 3 blocks), the cached ones step for step
against the port's first-block caches (``caching.fbcache``), and the
uncached ones against the JAX package's offloaded forwards. Weights come
from the JAX ``random_init`` through ``convert.*_from_jax_params``, inputs
from seeded numpy generators.

On the CPU a streamed block runs the same plain twins as a resident one, so
the offloaded outputs equal the resident ones bit for bit and the cache
hits agree step for step. Against JAX's offloaded forwards: within 2e-2 of
the reference's max |value|, the port's FLUX model bound
(tests/test_torch_flux.py; the JAX offload tests' 2e-2 is absolute, JAX
against itself), the int4 models' AdaLN modulation damped as
tests/test_torch_int4_flux.py damps it.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.models.transformers.transformer_qwenimage import QwenImageConfig as JaxQwenConfig
from nunchaku_tpu.models.transformers.transformer_qwenimage import QwenImageTransformer2DModel as JaxQwen
from nunchaku_tpu.utils import offload as joff
from nunchaku_tpu_torch.caching.fbcache import (fb_cached_forward, init_fb_state, init_qwen_fb_state,
                                                qwenimage_fb_cached_forward)
from nunchaku_tpu_torch.convert import flux_from_jax_params, qwenimage_from_jax_params, to_torch
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig
from nunchaku_tpu_torch.ops.checks import MOD_DAMP
from nunchaku_tpu_torch.utils.offload import (BlockStreamer, OffloadedCachedFluxForward,
                                              OffloadedCachedQwenImageForward, OffloadedFluxForward,
                                              OffloadedQwenImageForward)

SMALL = dict(num_layers=2, num_single_layers=2, num_attention_heads=2, joint_attention_dim=512,
             pooled_projection_dim=256)
QWEN = dict(num_layers=3, num_attention_heads=2, joint_attention_dim=320)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _damp(blocks, names):
    for name in names:
        lin = getattr(blocks, name).linear
        lin.wscales = (lin.wscales.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
        lin.wzeros = (lin.wzeros.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)


def _params(jm):
    return {k: np.asarray(v) for k, v in jm.named_parameters()}


def _flux_inputs(seed=40):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    ids = np.zeros((64, 3), np.int32)
    ids[:, 1], ids[:, 2] = np.arange(64) // 8, np.arange(64) % 8
    return (bf(rng.standard_normal((1, 64, 64))), bf(rng.standard_normal((1, 32, 512))),
            bf(rng.standard_normal((1, 256))), np.array([0.5], np.float32), ids, np.zeros((32, 3), np.int32),
            np.array([3.5], np.float32))


def _qwen_inputs(seed=41):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    ids = np.zeros((64, 3), np.int32)
    ids[:, 1], ids[:, 2] = np.arange(64) // 8, np.arange(64) % 8
    return bf(rng.standard_normal((1, 64, 64))), bf(rng.standard_normal((1, 16, 320))), np.array([0.5], np.float32), ids


def _rel(out, ref):
    out = out.float().numpy()
    return np.abs(out - ref).max() / np.abs(ref).max()


def _t(args):
    return [to_torch(a, "cpu") for a in args]


@pytest.fixture(scope="module", params=["int4", "w4a8"])
def flux(request):
    jm = JaxFlux.random_init(jax.random.PRNGKey(5), JaxFluxConfig(precision=request.param, **SMALL))
    if request.param == "int4":
        _damp(jm.transformer_blocks, ("norm1", "norm1_context"))
        _damp(jm.single_transformer_blocks, ("norm",))
    tm = flux_from_jax_params(_params(jm), FluxConfig(precision=request.param, **SMALL), device="cpu")
    with torch.no_grad():
        ref = tm(*_t(_flux_inputs()))
    return jm, tm, ref


@pytest.fixture(scope="module")
def qwen():
    jm = JaxQwen.random_init(jax.random.PRNGKey(6), JaxQwenConfig(precision="int4", **QWEN))
    _damp(jm.blocks, ("norm1", "norm1_context"))
    tm = qwenimage_from_jax_params(_params(jm), QwenImageConfig(precision="int4", **QWEN), device="cpu")
    with torch.no_grad():
        ref = tm(*_t(_qwen_inputs()))
    return jm, tm, ref


@pytest.mark.parametrize("lookahead", [1, 2])
def test_offloaded_flux_matches_resident_and_jax(flux, lookahead):
    """``OffloadedFluxForward`` equals the resident forward bit for bit at
    lookahead 1 and 2, and JAX's offloaded forward within 2e-2. Its model
    takes the stacks from the model it is given: the model keeps no tensor
    of them (skeletons of their settings) and no layer views."""
    jm, tm, ref = flux
    model = copy.deepcopy(tm)
    model.layer_views()
    off = OffloadedFluxForward(model, lookahead=lookahead)
    out = off(*_t(_flux_inputs()))
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    assert off.model is model and model._views is None and off.dual.lookahead == lookahead
    assert not list(model.transformer_blocks.buffers()) and not list(model.single_transformer_blocks.buffers())
    jout = np.asarray(joff.OffloadedFluxForward(jm, lookahead=lookahead)(*map(jnp.asarray, _flux_inputs())), np.float32)
    assert _rel(out, jout) <= 2e-2


def test_offloaded_cached_flux_matches_fb_cache(flux):
    """``OffloadedCachedFluxForward`` against ``fb_cached_forward`` on the
    resident model over three steps (the second input repeats the first, the
    third is new) at thresholds 1e9 (every step after the first hits), 0.12
    and -1 (never hits): equal outputs and hits step for step; the decision
    block is a module of its own."""
    _, tm, ref = flux
    steps = [_t(_flux_inputs()), _t(_flux_inputs()), _t(_flux_inputs(seed=42))]
    for threshold, want_hits in ((1e9, 2), (0.12, None), (-1.0, 0)):
        off = OffloadedCachedFluxForward(copy.deepcopy(tm), residual_diff_threshold=threshold)
        state = init_fb_state(1, 64, 32, tm.cfg.dim, device="cpu")
        for k, args in enumerate(steps):
            with torch.no_grad():
                want, state = fb_cached_forward(tm, state, *args, residual_diff_threshold=threshold)
            assert torch.equal(off(*args), want), (threshold, k)
            assert off.hits == state.hits and off.steps == k + 1
        assert want_hits is None or off.hits == want_hits
    assert torch.equal(OffloadedCachedFluxForward(copy.deepcopy(tm))(*steps[0]), ref)
    assert off.block0.attn.to_qkv.qweight.data_ptr() != tm.transformer_blocks.attn.to_qkv.qweight.data_ptr()


def test_offloaded_qwen_matches_resident_and_jax(qwen):
    """``OffloadedQwenImageForward`` equals the resident forward bit for bit
    and JAX's offloaded forward within 2e-2."""
    jm, tm, ref = qwen
    model = copy.deepcopy(tm)
    out = OffloadedQwenImageForward(model)(*_t(_qwen_inputs()))
    assert not list(model.blocks.buffers()) and model._views is None
    assert torch.equal(out, ref)
    jout = np.asarray(joff.OffloadedQwenImageForward(jm)(*map(jnp.asarray, _qwen_inputs())), np.float32)
    assert _rel(out, jout) <= 2e-2


@pytest.mark.parametrize("fn_blocks", [1, 2, 8], ids=["fn1", "fn2", "fn8-capped"])
def test_offloaded_cached_qwen_matches_fb_cache(qwen, fn_blocks):
    """``OffloadedCachedQwenImageForward`` against
    ``qwenimage_fb_cached_forward`` on the resident model, three steps as
    the FLUX test, at each ``fn_blocks`` (8 is capped at L - 1 = 2): equal
    outputs and hits step for step."""
    _, tm, _ = qwen
    steps = [_t(_qwen_inputs()), _t(_qwen_inputs()), _t(_qwen_inputs(seed=43))]
    off = OffloadedCachedQwenImageForward(copy.deepcopy(tm), residual_diff_threshold=0.12, fn_blocks=fn_blocks)
    assert off.fn == min(fn_blocks, 2) and len(off.head_blocks) == off.fn
    state = init_qwen_fb_state(1, 64, tm.cfg.dim, device="cpu")
    for k, args in enumerate(steps):
        with torch.no_grad():
            want, state = qwenimage_fb_cached_forward(tm, state, *args, residual_diff_threshold=0.12,
                                                      fn_blocks=fn_blocks)
        assert torch.equal(off(*args), want), k
        assert off.hits == state.hits
    assert off.hits >= 1  # the repeated input hits


def test_block_streamer_layout_and_start(flux):
    """A block's flat host copy keeps each buffer's layout (the int4 and
    w4a8 weights K-contiguous where the stack keeps them so), every buffer
    at a 256-byte offset; ``run(start=)`` runs the layers from ``start``."""
    _, tm, _ = flux
    st = BlockStreamer(tm.single_transformer_blocks, 2)
    view = tm.layer_views()["single_transformer_blocks"][1]
    block = st._bind(st.host[1])
    for name, t in view.named_buffers():
        got = block.get_buffer(name)
        assert got.stride() == t.stride() and torch.equal(got, t), name
        assert (got.data_ptr() - st.host[1].data_ptr()) % 256 == 0, name
    assert st.host_bytes == 2 * st.nbytes and not st.host[0].is_pinned()
    seen = st.run(lambda blk, c: c + [blk.mlp_fc1.qweight.clone()], [], start=1)
    assert len(seen) == 1 and torch.equal(seen[0], view.mlp_fc1.qweight)
