"""FLUX's block-sparse attention in the port against the JAX package (CPU):
``select_blocks``, the plain twins of both kernel forms against the JAX
``block_sparse_attention`` in Pallas interpret mode, the masked-dense
oracle, and the small FLUX model under ``set_attention_impl("blocksparse",
0.5)`` with converted weights.

Tolerances, each as max error / max |JAX value|:
- the selection: equal ids, on scores free of ties (``torch.topk`` and
  ``jax.lax.top_k`` may order ties differently; each case asserts a gap);
- the fixed-shift twin: 1e-2 (the TPU kernel's arithmetic; f32 sums in
  another order round some bf16 outputs one step apart);
- the online twin: 2e-2 (it rescales every 32 kv columns, the TPU kernel
  once per kv block: p rounds to bf16 against another running max);
- the oracles: 1e-2 (f32 softmax in another order, bf16 output);
- the model: 2e-2, as tests/test_torch_flux.py (int4 damped as in
  tests/test_torch_int4_flux.py).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.ops import attention as jatt
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.ops import attention as tatt

from test_torch_int4_flux import TINY, damped_jax_model

S_IMG, S_TXT = 1600, 64  # 40 x 40 latent tokens + text: 2 kv blocks of 1536 (a ragged tail of 128), 3 query blocks
CASES = [(640, 640, 0.4, 128, 128), (512, 500, 0.5, 128, 128), (1024, 1024, 0.5, 256, 256)]  # tests/test_ops.py's


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(out, ref):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _qkv(seed, s, skv, h=2, d=128):
    rng = np.random.default_rng(seed)
    bf = lambda shape: np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    return bf((1, h, s, d)), bf((1, h, skv, d)), bf((1, h, skv, d))


def _t(a):
    return to_torch(a, "cpu")


def _pooled_gap(q, k, kk, bq, bkv):
    """Smallest gap, over all query blocks, between the kk-th and the
    (kk+1)-th pooled score (f64 from the bf16 inputs), relative to the
    scores' spread: how far the selection is from a tie."""
    def pool(t, blk):
        s = t.shape[2]
        n = -(-s // blk)
        t = np.pad(t.astype(np.float64), ((0, 0), (0, 0), (0, n * blk - s), (0, 0))).reshape(*t.shape[:2], n, blk, -1)
        return t.sum(3) / np.clip(s - np.arange(n) * blk, 1, blk)[:, None]

    scores = np.sort(pool(q.astype(np.float32), bq) @ np.swapaxes(pool(k.astype(np.float32), bkv), -1, -2))[..., ::-1]
    if scores.shape[-1] == kk:
        return np.inf
    return (scores[..., kk - 1] - scores[..., kk]).min() / np.ptp(scores)


@pytest.mark.parametrize("s,skv,ratio,bq,bkv", CASES + [(S_IMG + S_TXT, S_IMG + S_TXT, 0.5, 768, 1536)])
def test_select_blocks_matches_jax(s, skv, ratio, bq, bkv):
    q, k, _ = _qkv(1, s, skv)
    ref = np.asarray(jatt.select_blocks(jnp.asarray(q), jnp.asarray(k), ratio, bq=bq, bkv=bkv))
    nk = -(-skv // bkv)
    kk = max(1, int(nk * (1 - ratio)))  # int truncates: 0.4 of 5 blocks keeps 3
    assert ref.shape == (1, 2, -(-s // bq), kk)
    assert _pooled_gap(q, k, kk, bq, bkv) > 1e-4  # the inputs are free of ties
    out = tatt.select_blocks(_t(q), _t(k), ratio, bq=bq, bkv=bkv)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("s,skv,ratio,bq,bkv", CASES)
def test_twins_match_jax(s, skv, ratio, bq, bkv, fixed):
    """Scale None (1/sqrt(D), applied in the kernel), the JAX selection
    passed in as ``block_idx``."""
    q, k, v = _qkv(2, s, skv)
    idx = jatt.select_blocks(jnp.asarray(q), jnp.asarray(k), ratio, bq=bq, bkv=bkv)
    ref = jatt.block_sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sparsity_ratio=ratio,
                                      block_idx=idx, bq=bq, bkv=bkv, fixed_softmax=fixed)
    out = tatt.block_sparse_attention(_t(q), _t(k), _t(v), sparsity_ratio=ratio, block_idx=_t(np.asarray(idx)),
                                      bq=bq, bkv=bkv, fixed_softmax=fixed)
    assert out.shape == (1, 2, s, 128) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= (1e-2 if fixed else 2e-2)


@pytest.mark.parametrize("fixed", [True, False])
def test_prescaled_bshd_matches_jax(fixed):
    """The FLUX route: q prescaled by scale * log2(e), scale 1.0, (B, S, H*D)
    out, the selection made inside from the prescaled q (a ragged query
    block of 128 rows)."""
    b, h, s, d = 1, 2, 640, 128
    q, k, v = _qkv(3, s, s)
    qp = np.asarray((jnp.asarray(q, jnp.float32) * (jatt.LOG2E / math.sqrt(d))).astype(jnp.bfloat16))
    kw = dict(sparsity_ratio=0.5, bq=256, bkv=128, scale=1.0, out_bshd=True, fixed_softmax=fixed)
    ref = jatt.block_sparse_attention(jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v), **kw)
    out = tatt.block_sparse_attention(_t(qp), _t(k), _t(v), **kw)
    assert out.shape == (b, s, h * d)
    assert _rel(out, ref) <= (1e-2 if fixed else 2e-2)


@pytest.mark.parametrize("fixed", [True, False])
def test_zero_sparsity_is_dense(fixed):
    """Sparsity 0 selects every block: the JAX dense oracle."""
    q, k, v = _qkv(4, 384, 384)
    ref = jatt.sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tatt.block_sparse_attention(_t(q), _t(k), _t(v), sparsity_ratio=0.0, fixed_softmax=fixed)
    assert _rel(out, ref) <= (1e-2 if fixed else 2e-2)


@pytest.mark.parametrize("fixed", [True, False])
def test_block_idx_passed_in(fixed):
    """Ids of the caller's choosing (not the top-k ones; the ragged tail
    block 3 of 500 columns in every row) on both sides and in the oracle."""
    q, k, v = _qkv(5, 512, 500)
    idx = np.broadcast_to(np.array([1, 3], np.int32), (1, 2, 4, 2)).copy()
    kw = dict(sparsity_ratio=0.5, block_idx=idx, bq=128, bkv=128, fixed_softmax=fixed)
    ref = jatt.block_sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out = tatt.block_sparse_attention(_t(q), _t(k), _t(v), **(kw | dict(block_idx=_t(idx))))
    oracle = tatt.block_sparse_reference(_t(q), _t(k), _t(v), _t(idx), bq=128, bkv=128)
    assert _rel(out, ref) <= (1e-2 if fixed else 2e-2)
    assert _rel(out, oracle.float().numpy()) <= 2e-2


@pytest.mark.parametrize("s,skv,ratio,bq,bkv", CASES)
def test_reference_matches_jax(s, skv, ratio, bq, bkv):
    q, k, v = _qkv(6, s, skv)
    idx = np.asarray(jatt.select_blocks(jnp.asarray(q), jnp.asarray(k), ratio, bq=bq, bkv=bkv))
    ref = jatt.block_sparse_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx), bq=bq, bkv=bkv)
    out = tatt.block_sparse_reference(_t(q), _t(k), _t(v), _t(idx), bq=bq, bkv=bkv)
    assert out.dtype == torch.bfloat16 and _rel(out, ref) <= 1e-2


def _inputs():
    rng = np.random.default_rng(61)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    ids = np.zeros((S_IMG, 3), np.int32)
    ids[:, 1] = np.arange(S_IMG) // 40
    ids[:, 2] = np.arange(S_IMG) % 40
    return (bf(rng.standard_normal((1, S_IMG, 64))), bf(rng.standard_normal((1, S_TXT, 512))),
            bf(rng.standard_normal((1, 256))), np.array([0.5], np.float32), ids, np.zeros((S_TXT, 3), np.int32),
            np.array([3.5], np.float32))


@pytest.mark.parametrize("precision", ["w4a8", "int4"])
def test_flux_blocksparse_matches_jax(precision, monkeypatch):
    """Both FLUX blocks take block-sparse attention (one selected kv block
    of two per query block)."""
    if precision == "int4":
        jm, params = damped_jax_model("int4")
    else:
        jm = JaxFlux.random_init(jax.random.PRNGKey(3), JaxFluxConfig(precision="w4a8", **TINY))
        params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = flux_from_jax_params(params, FluxConfig(precision=precision, **TINY), device="cpu")
    args = _inputs()
    jm.set_attention_impl("blocksparse", sparsity_ratio=0.5)
    ref = np.asarray(jax.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, args)), np.float32)
    calls, select = [], tatt.select_blocks
    monkeypatch.setattr(tatt, "select_blocks", lambda *a, **kw: calls.append(1) or select(*a, **kw))
    tm.set_attention_impl("blocksparse", sparsity_ratio=0.5)
    with torch.no_grad():
        out = tm(*[_t(a) for a in args])
    assert len(calls) == 2 and out.shape == (1, S_IMG, 64)
    assert _rel(out, ref) <= 2e-2



def test_fused_prologue_and_unknown_impls_raise():
    """Blocksparse after enable_fused_qkv_prep() reaches the unfused branch
    with the half-split rope table and raises, on both sides; an unknown
    impl and a ratio outside (0, 1) raise; flashattn2 turns sparsity off."""
    jm = JaxFlux.random_init(jax.random.PRNGKey(3), JaxFluxConfig(precision="w4a8", **TINY))
    tm = flux_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()},
                              FluxConfig(precision="w4a8", **TINY), device="cpu")
    args = _inputs()
    jm.set_stream_dtype(jnp.bfloat16).enable_fused_qkv_prep().set_attention_impl("blocksparse", sparsity_ratio=0.5)
    with pytest.raises(ValueError, match="half-split"):
        jm(*map(jnp.asarray, args))
    tm.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep().set_attention_impl("blocksparse", sparsity_ratio=0.5)
    with pytest.raises(ValueError, match="half-split"), torch.no_grad():
        tm(*[_t(a) for a in args])
    for model in (jm, tm):
        with pytest.raises(ValueError, match="unknown attention impl"):
            model.set_attention_impl("sage")
        for ratio in (0.0, 1.0):
            with pytest.raises(ValueError, match="sparsity_ratio"):
                model.set_attention_impl("blocksparse", sparsity_ratio=ratio)
    tm.set_attention_impl("nunchaku-fp16")
    assert all(b.attn.sparsity_ratio == 0.0 for views in tm.layer_views().values() for b in views)
