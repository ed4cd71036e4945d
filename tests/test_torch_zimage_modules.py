"""The Z-Image modules of the port against the JAX package on the CPU, on
the tiny models of tests/test_torch_zimage.py (whose docstring gives the
weights and the tolerances): the attention with its interleaved and its
half-split prologue, the SwiGLU feed-forward and both block forms
(modulated, and the unmodulated context refiner) at int4, int8, w4a8 and
nvfp4, each port module a layer view attached to its stack, each JAX one the
stack's layer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_zimage import (JZ, PRECISIONS, S_IMG, S_TXT, TINY, TOL, _bf16, _jax_layer, _jax_rot, _one_torch_thread,
                               _port_rot, _rel, _t, tiny_models)  # noqa: F401 (an autouse fixture)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _module_x(seed, s=S_TXT + S_IMG, scale=1.0):
    return _bf16(np.random.default_rng(seed).standard_normal((1, s, 512)) * scale)


@pytest.mark.parametrize("fused", [False, True], ids=["interleaved", "halfsplit"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_attention_matches_jax(precision, fused):
    """Layer 1's attention (joint 64 + 256 tokens) on identical inputs and
    rope tables: the interleaved q/k RMSNorm + RoPE, or after the fused prep
    the half-split one through the qkv/RoPE producer's twin; then the
    fixed-shift flash twin and the output projection. Within twice the JAX
    routes' spread on this attention (TOL)."""
    jm, _, tm = tiny_models(precision, fused)
    x = _module_x(96)
    rot = _jax_rot(fused)
    ref = jax.jit(lambda b, a, r: b.attention(a, r))(_jax_layer(jm, 1), jnp.asarray(x), rot)
    with torch.no_grad():
        out = tm.layer_views()["layers"][1].attention(_t(x), _port_rot(rot))
    assert out.shape == ref.shape == (1, S_TXT + S_IMG, 512) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= TOL["attention"][precision]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_feed_forward_matches_jax(precision):
    """Layer 0's SwiGLU feed-forward (w13, the SiLU GLU fused into w2's
    quantize, w2) on identical inputs, within twice the JAX routes' spread
    (TOL; XLA's SiLU and torch's round a few GLU products to neighbouring
    bf16 values, which moves some of w2's 4-bit codes)."""
    jm, _, tm = tiny_models(precision)
    x = _module_x(97, scale=0.5)
    ref = jax.jit(lambda b, a: b.feed_forward(a))(_jax_layer(jm, 0), jnp.asarray(x))
    with torch.no_grad():
        out = tm.layer_views()["layers"][0].feed_forward(_t(x))
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= TOL["feed_forward"][precision]


@pytest.mark.parametrize("form", ["modulated", "context"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_block_matches_jax(precision, form):
    """A modulated main layer (layer 1, the joint stream, tanh-gated adaLN)
    and the unmodulated context refiner (its layer 0, caption tokens only)
    on an f32 stream: within twice the JAX routes' spread on each (TOL)."""
    jm, _, tm = tiny_models(precision)
    rng = np.random.default_rng(98)
    if form == "modulated":
        jb, tb = _jax_layer(jm, 1), tm.layer_views()["layers"][1]
        xs = (rng.standard_normal((1, S_TXT + S_IMG, 512)) * 2).astype(np.float32)
        temb = _bf16(rng.standard_normal((1, 512)))
        rot = _jax_rot(False)
    else:
        jb = jax.tree.map(lambda a: a[0], jm.context_refiner)
        tb = tm.layer_views()["context_refiner"][0]
        xs = (rng.standard_normal((1, S_TXT, 512)) * 2).astype(np.float32)
        temb = None
        rot = JZ.rope_table(jnp.zeros((S_TXT, 3), jnp.int32), TINY["axes_dims_rope"])
    ref = jax.jit(lambda b, a, t, r: b(a, t, r))(jb, jnp.asarray(xs), None if temb is None else jnp.asarray(temb), rot)
    with torch.no_grad():
        out = tb(torch.from_numpy(xs), _t(temb), _t(rot))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= TOL[form][precision]
