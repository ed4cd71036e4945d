"""FLUX.1 and Qwen-Image of the port on stacked layers against the JAX
package's scans (CPU), at depths where a wrong layer index shows: FLUX with
2 dual and 3 single blocks at dim 768 (the MLP's 3072 hidden columns make
two requantize groups, so the grouped consumer runs), Qwen-Image with 3
joint blocks; weights from the JAX ``random_init`` carried by
``convert.*_from_jax_params``, inputs from seeded numpy generators.

Paths: int8 in the turbo configuration with the grouped chain and with the
per-token chain (``NUNCHAKU_TPU_CHAIN_PTOKEN=1`` on both sides), w4a8 on
the dequant route and on the packed route (``NUNCHAKU_TPU_W4A8_XLA=0``,
``..._FUSED=1``), a 2-step ``double_fb`` request, Qwen-Image int4 (AdaLN
damped, as tests/test_torch_qwenimage.py) and w4a8 with a padded-prompt
mask; and the checkpoint loader and ``requantize_model`` into stacks of 2 +
3 layers, buffer for buffer against the JAX loaders'.

Tolerance: model outputs and latents within 2e-2 of the reference's max
|value|, as tests/test_torch_flux.py holds the one-block models. The JAX
package reads the route switches while it traces: each test sets them
(monkeypatch) before it traces anew.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_checkpoints as ckpt
from nunchaku_tpu.models import requantize as jreq
from nunchaku_tpu.models.transformers.loader import load_flux_transformer as jax_load_flux
from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.models.transformers.transformer_qwenimage import QwenImageConfig as JaxQwenConfig
from nunchaku_tpu.models.transformers.transformer_qwenimage import QwenImageTransformer2DModel as JaxQwen
from nunchaku_tpu.pipeline.pipeline_flux import FluxPipeline as JaxPipeline
from nunchaku_tpu_torch.convert import flux_from_jax_params, qwenimage_from_jax_params, to_torch
from nunchaku_tpu_torch.models import requantize as treq
from nunchaku_tpu_torch.models.loader import load_flux_transformer
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig
from nunchaku_tpu_torch.ops import gemm as tgemm
from nunchaku_tpu_torch.ops.checks import MOD_DAMP
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

from test_torch_flux import S_IMG, _inputs, _rel
from test_torch_qwenimage import TINY as QWEN_TINY
from test_torch_qwenimage import inputs as qwen_inputs

STACKED = dict(num_layers=2, num_single_layers=3, num_attention_heads=6, joint_attention_dim=512,
               pooled_projection_dim=256)
CHAINS = 2 * STACKED["num_layers"] + STACKED["num_single_layers"]  # MLP chains per forward: 2 a dual, 1 a single


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small torch ops: one intra-op thread keeps
    their time steady when a parallel test run keeps every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(precision, seed, turbo):
    jm = JaxFlux.random_init(jax.random.PRNGKey(seed), JaxFluxConfig(precision=precision, **STACKED))
    tm = flux_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()},
                              FluxConfig(precision=precision, **STACKED), device="cpu")
    if turbo:
        jm.set_stream_dtype(jnp.bfloat16).enable_fused_qkv_prep()
        tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    return jm, tm


@pytest.fixture(scope="module")
def int8_turbo():
    return _pair("int8", 11, True)


@pytest.fixture(scope="module")
def w4a8():
    return _pair("w4a8", 12, False)


def _forward(jm, tm):
    ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, _inputs())), np.float32)
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in _inputs()])
    assert out.shape == (1, S_IMG, 64)
    return out, ref


@pytest.fixture
def layers_read(monkeypatch):
    """(stack length, layer index) of every stacked twin call (``layer_of``),
    and the consumer entry points called."""
    calls = {"layers": [], "gemm_w8a8_grouped_res": 0, "gemm_w8a8_rank1": 0}
    layer_of = tgemm.layer_of

    def spy_layer(stack, idx):
        calls["layers"].append((stack.shape[0], int(idx)))
        return layer_of(stack, idx)

    monkeypatch.setattr(tgemm, "layer_of", spy_layer)
    for name in ("gemm_w8a8_grouped_res", "gemm_w8a8_rank1"):
        fn = getattr(tgemm, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tgemm, name, spy)
    return calls


@pytest.mark.parametrize("ptoken", ["0", "1"], ids=["grouped", "ptoken"])
def test_int8_turbo_matches_jax_scan(monkeypatch, int8_turbo, layers_read, ptoken):
    """FLUX int8 turbo (``bench.py --dense``'s configuration) on stacks:
    each MLP chain's producer and consumer read their layer of the int8
    stacks (each dual layer 4 times: two chains of two kernels; each single
    layer twice), the consumer in its gated-residual epilogue, grouped or
    (per-token chain) rank-1; the output within 2e-2 of the JAX scan's
    under the same switch."""
    monkeypatch.setenv("NUNCHAKU_TPU_CHAIN_PTOKEN", ptoken)
    out, ref = _forward(*int8_turbo)
    assert _rel(out, ref) <= 2e-2
    L, Ls = STACKED["num_layers"], STACKED["num_single_layers"]
    want = sorted([(L, i) for i in range(L) for _ in range(4)] + [(Ls, i) for i in range(Ls) for _ in range(2)])
    assert sorted(layers_read["layers"]) == want
    consumer = "gemm_w8a8_rank1" if ptoken == "1" else "gemm_w8a8_grouped_res"
    assert layers_read[consumer] == CHAINS and layers_read["gemm_w8a8_rank1" if ptoken == "0" else
                                                            "gemm_w8a8_grouped_res"] == 0


@pytest.mark.parametrize("switches", [("1", "0"), ("0", "1")], ids=["dequant", "packed"])
def test_w4a8_matches_jax_scan(monkeypatch, w4a8, switches):
    """FLUX w4a8 (default configuration) on stacks: the dequant route (the
    stacked dequant of every linear, both chain stacks included) and the
    packed route (the stacked packed GEMM, W4 producer and grouped packed
    consumer), each within 2e-2 of the JAX scan's under the same switches."""
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", switches[0])
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_FUSED", switches[1])
    out, ref = _forward(*w4a8)
    assert _rel(out, ref) <= 2e-2


def test_double_fb_request_matches_jax(int8_turbo):
    """A 2-step ``double_fb`` request at hit ratio 0.5 (step 1 hits): block 0
    alone, then the rest of each stack from layer 1 (the port passes the
    absolute index into the whole stack, JAX the index into the slice)."""
    jm, tm = int8_turbo
    lat, txt, pooled = _inputs()[:3]
    kw = dict(height=256, width=256, num_inference_steps=2, cache="double_fb", cache_hit_ratio=0.5)
    ref = JaxPipeline(jm, vae=None)(prompt_embeds=jnp.asarray(txt), pooled_prompt_embeds=jnp.asarray(pooled),
                                    latents=jnp.asarray(lat), **kw)
    out = FluxPipeline(tm, vae=None)(prompt_embeds=to_torch(txt, "cpu"), pooled_prompt_embeds=to_torch(pooled, "cpu"),
                                     latents=to_torch(lat, "cpu"), **kw)
    assert out.cache_hits == int(ref.cache_hits) == 1
    assert _rel(out.latents, ref.latents) <= 2e-2


def test_stacks_views_and_indices(w4a8):
    """The blocks are two stacked modules; the forward loops over layer
    views whose 4-bit linears read the stacks by 0-d int32 indices made
    once; an attention setting (``set_attention_impl``, ``set_on_stacks``)
    or the fused prep rebuilds the views."""
    _, tm = w4a8
    assert tm.transformer_blocks.ff.fc1.qweight.shape[0] == STACKED["num_layers"]
    assert tm.single_transformer_blocks.mlp_fc1.qweight.shape[0] == STACKED["num_single_layers"]
    ids = tm.layer_ids()
    assert [int(i) for i in ids["single_transformer_blocks"]] == list(range(STACKED["num_single_layers"]))
    assert all(i.dim() == 0 and i.dtype == torch.int32 for v in ids.values() for i in v)
    view = tm.layer_views()["transformer_blocks"][1]
    assert view.attn.to_qkv._stacked_qweight is tm.transformer_blocks.attn.to_qkv.qweight
    assert view.attn.to_qkv._layer_idx is ids["transformer_blocks"][1] and tm.layer_ids() is not None
    assert tm.layer_ids()["transformer_blocks"][1] is ids["transformer_blocks"][1]  # made once
    tm.set_attention_impl("blocksparse", sparsity_ratio=0.5)
    assert tm.layer_views()["transformer_blocks"][1].attn.sparsity_ratio == 0.5
    tm.set_attention_impl("flashattn2")
    assert tm.layer_views()["transformer_blocks"][1].attn.sparsity_ratio == 0.0
    tm.set_on_stacks("attn", fixed_softmax=False)
    assert not tm.layer_views()["single_transformer_blocks"][2].attn.fixed_softmax
    tm.set_on_stacks("attn", fixed_softmax=True)
    assert tm.layer_views()["single_transformer_blocks"][2].attn.fixed_softmax


def _qwen_pair(precision, seed):
    jm = JaxQwen.random_init(jax.random.PRNGKey(seed), JaxQwenConfig(precision=precision, **dict(QWEN_TINY,
                                                                                               num_layers=3)))
    if precision == "int4":
        for name in ("norm1", "norm1_context"):
            lin = getattr(jm.blocks, name).linear
            lin.wscales = (lin.wscales.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
            lin.wzeros = (lin.wzeros.astype(jnp.float32) * MOD_DAMP).astype(jnp.bfloat16)
    tm = qwenimage_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()},
                                   QwenImageConfig(precision=precision, **dict(QWEN_TINY, num_layers=3)), device="cpu")
    return jm, tm


@pytest.mark.parametrize("precision", ["int4", "w4a8"])
def test_qwenimage_three_blocks_match_jax_scan(precision):
    """Qwen-Image's ``run_blocks`` over its stack of 3 joint blocks, B 2 with
    a padded prompt (row 1 keeps 9 of 24 text keys), within 2e-2 of the JAX
    scan's."""
    jm, tm = _qwen_pair(precision, 13)
    assert tm.blocks.ff.fc1.qweight.shape[0] == 3
    lat, txt, t, ids, mask = qwen_inputs()
    ref = np.asarray(jax.jit(lambda m, *a, **k: m(*a, **k))(
        jm, *map(jnp.asarray, (lat, txt, t, ids)), encoder_hidden_states_mask=jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        out = tm(*[to_torch(a, "cpu") for a in (lat, txt, t, ids)], encoder_hidden_states_mask=torch.from_numpy(mask))
    assert _rel(out, ref) <= 2e-2


@pytest.mark.parametrize("precision", [None, "int8", "w4a8"])
def test_loader_and_requantize_into_stacks(monkeypatch, tmp_path, precision):
    """A synthesized int4 file of 2 dual and 3 single blocks loads into
    stacks whose every buffer equals the JAX loader's stacked leaf bit for
    bit (at int4, int8 and w4a8), and ``requantize_model`` of the int4 model
    into int8 stacks equals JAX's."""
    monkeypatch.setitem(ckpt.FLUX, "layers", STACKED["num_layers"])
    monkeypatch.setitem(ckpt.FLUX, "single", STACKED["num_single_layers"])
    path = ckpt.flux_checkpoint(tmp_path / "flux.safetensors", "int4", seed=3)
    tm = load_flux_transformer(path, precision, device="cpu")
    assert tm.single_transformer_blocks.mlp_fc2.qweight.shape[0] == STACKED["num_single_layers"]
    ckpt.assert_same_as_jax(tm, jax_load_flux(path, precision=precision))
    if precision is None:
        ckpt.assert_same_as_jax(treq.requantize_model(tm, "int8"), jreq.requantize_model(jax_load_flux(path), "int8"))


@pytest.mark.parametrize("precision", ["int8", "w4a8"])
def test_rank128_turbo_matches_jax_scan(monkeypatch, precision):
    """FLUX at rank 128 (nunchaku's rank-128 checkpoints) in the turbo
    configuration on stacks: the LN producer, the qkv/RoPE producer (both
    with a 128-wide low-rank term) and, at int8, the chain kernels; w4a8 on
    the dequant route (the route that keeps the LN producer). The output
    within 2e-2 of the JAX scan's, the rank-32 turbo test's bound."""
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_XLA", "1")
    monkeypatch.setenv("NUNCHAKU_TPU_W4A8_FUSED", "0")
    jm = JaxFlux.random_init(jax.random.PRNGKey(21), JaxFluxConfig(precision=precision, rank=128, **STACKED))
    tm = flux_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()},
                              FluxConfig(precision=precision, rank=128, **STACKED), device="cpu")
    jm.set_stream_dtype(jnp.bfloat16).enable_fused_qkv_prep()
    tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    assert tm.transformer_blocks.attn.to_qkv.proj_down.shape[-1] == 128
    out, ref = _forward(jm, tm)
    assert _rel(out, ref) <= 2e-2
