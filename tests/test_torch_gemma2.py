"""The port's Gemma-2 encoder against the JAX package's on the CPU: a tiny
encoder (2 layers, d 64, GQA 4 / 2 heads of 16, inter 128, vocab 256) from
one seeded set of numpy parameters, carried into the port by
``gemma2_from_jax_params``, on the same token ids without and with an
attention mask; and ``load_gemma2_encoder`` of one HF-layout state dict in
both packages.

The query and key weights are drawn large enough that the logits reach the
soft-cap's bend (|s| / 50 up to ~1), where ``tanh`` matters. XLA's CPU tanh
and torch's differ by up to ~1e-6 on f32 (ROADMAP Queue 3), which can move
a bf16 rounding downstream (and the f32 sums run in another order), so the
hidden states are held to max error <= 1e-2 of max |ref| (measured on the
CPU: 4.6e-3, 0.6% of the elements one bf16 step apart).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.text_encoders import gemma2 as J
from nunchaku_tpu_torch.convert import gemma2_from_jax_params
from nunchaku_tpu_torch.models.text_encoders import gemma2 as T

TINY = dict(heads=4, kv_heads=2, head_dim=16)
TOL = 1e-2


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", None))) for k in path)


@pytest.fixture(scope="module")
def models():
    struct = jax.eval_shape(lambda k: J.Gemma2Encoder.random_init(k, d=64), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(struct)
    rng = np.random.default_rng(0)
    params = {}
    for p, s in leaves:
        name = _dotted(p)
        part, leaf = name.split(".")[-2:] if "." in name else ("", name)
        if leaf == "weight":
            v = rng.standard_normal(s.shape) * (0.5 if part in ("q", "k") else 0.05)
        else:  # biases, the (1 + w) norm gains, the embedding
            v = rng.standard_normal(s.shape) * 0.1
        params[name] = np.asarray(jnp.asarray(v, s.dtype))
    jm = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(params[_dotted(p)]) for p, _ in leaves])
    return jm, params, gemma2_from_jax_params(params, **TINY, device="cpu")


def _ids(masked):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 40)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 40), np.int32)
        mask[1, 25:] = 0  # the second prompt padded after 25 tokens
    return ids, mask


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_encoder_matches_jax(models, masked):
    jm, _, tm = models
    ids, mask = _ids(masked)
    ref = np.asarray(jm(jnp.asarray(ids), None if mask is None else jnp.asarray(mask)), np.float32)
    out = tm(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    assert tuple(out.shape) == ref.shape == (2, 40, 64) and out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= TOL * np.abs(ref).max()


def test_softcap_binds(models):
    """The drawn weights put logits where tanh bends: the capped and the
    uncapped encoder differ (so the cap above is exercised)."""
    _, _, tm = models
    ids, _ = _ids(False)
    capped = tm(torch.from_numpy(ids)).float()
    for layer in tm.layers:
        layer.softcap = 0.0
    try:
        uncapped = tm(torch.from_numpy(ids)).float()
    finally:
        for layer in tm.layers:
            layer.softcap = 50.0
    assert (capped - uncapped).abs().max() > 1e-2 * capped.abs().max()


def test_loader_matches_jax():
    """``load_gemma2_encoder`` of one HF ``Gemma2Model`` state dict (numpy,
    ``model.`` prefix) in both packages: the same hidden states within TOL."""
    rng = np.random.default_rng(2)
    d, h, kv, hd, inter, vocab = 64, 4, 2, 16, 128, 256
    sd = {"model.embed_tokens.weight": rng.standard_normal((vocab, d)) * 0.1,
          "model.norm.weight": rng.standard_normal(d) * 0.1}
    for i in range(2):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (h * hd, d)), ("self_attn.k_proj", (kv * hd, d)),
                            ("self_attn.v_proj", (kv * hd, d)), ("self_attn.o_proj", (d, h * hd)),
                            ("mlp.gate_proj", (inter, d)), ("mlp.up_proj", (inter, d)),
                            ("mlp.down_proj", (d, inter))):
            sd[p + name + ".weight"] = rng.standard_normal(shape) * 0.1
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            sd[p + name + ".weight"] = rng.standard_normal(d) * 0.1
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    config = dict(num_layers=2, heads=h, kv_heads=kv, head_dim=hd, query_pre_attn_scalar=float(hd))
    jm = J.load_gemma2_encoder(sd, config=config)
    tm = T.load_gemma2_encoder(sd, config=config, device="cpu")
    ids = rng.integers(0, vocab, (1, 33)).astype(np.int32)
    ref = np.asarray(jm(jnp.asarray(ids)), np.float32)
    out = tm(torch.from_numpy(ids)).float().numpy()
    assert out.shape == ref.shape and np.abs(out - ref).max() <= TOL * np.abs(ref).max()
    assert T.GEMMA2_2B["d"] == 2304 and tm.layers[0].query_scale == hd ** -0.5
