"""The int8 chain's per-token and stacked modes of the port (``ops/gemm.py``)
against the JAX package's Pallas kernels in interpret mode (CPU), through
the plain twins: the per-token producer (``NUNCHAKU_TPU_CHAIN_PTOKEN=1``,
JAX ``_gemm_w8a8_gelu_quant_ptoken_kernel``), the stacked (layer-index)
modes of the int8 producer and of the consumer in grouped and rank-1 scale
modes, with and without the gated residual, and the stacked packed w4a8
pair. A stacked twin on layer i is the non-stacked twin on ``qweight[i]``
bit for bit.

Inputs come from seeded numpy generators; each test states its tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.core.packing import pack_int4
from nunchaku_tpu.ops import gemm as jgemm
from nunchaku_tpu_torch.convert import to_torch
from nunchaku_tpu_torch.ops import gemm as tgemm
from nunchaku_tpu_torch.ops.reference import bf16_matmul, gelu, int8_matmul

SHIFT = 0.171875
LAYERS = 3


def _t(a):
    return None if a is None else to_torch(np.asarray(a), "cpu")


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bf16_steps(out, ref):
    """Elements further apart than one bf16 rounding step (2^-7 |ref|, plus
    1e-4 of max |ref| for sums that cancel)."""
    out, ref = _np(out), _np(ref)
    return int((np.abs(out - ref) > 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).max()).sum())


def _int8_stack(rng, k, n):
    """An (L, K, N) int8 stack as the port keeps it (each layer K-contiguous)
    and as JAX keeps it (row-major)."""
    w = rng.integers(-127, 128, (LAYERS, k, n), dtype=np.int8)
    return torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))).transpose(1, 2), w


def _producer_inputs(seed, m=128, k=256, n=3072, r=32):
    """N 3072: the grouped producer's two 1536-column scale groups."""
    rng = np.random.default_rng(seed)
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = ((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32)
    ws = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k))).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    pu = _bf(rng.standard_normal((r, n)) * 0.02)
    bias = _bf(rng.standard_normal((n,)) * 0.02)
    rsm = (rng.random((n,)) + 0.5).astype(np.float32)
    pd = _bf(rng.standard_normal((n, r)) * 0.02)
    w_t, w_np = _int8_stack(rng, k, n)
    return (qa, asc, ws, la, pu, bias, rsm, pd), w_t, w_np


def _port_h(qa, asc, w, ws, la, pu, bias, rsm, unsigned):
    """h = (GELU(out) [+ shift]) / smooth_next of the port's twin."""
    out = int8_matmul(qa, w).float() * asc.reshape(-1, 1) * ws.reshape(1, -1)
    out = out + bf16_matmul(la, pu) + bias.reshape(1, -1).float()
    g = gelu(out)
    return ((g + SHIFT) if unsigned else g) * rsm.reshape(1, -1)


def _jax_h(qa, asc, w, ws, la, pu, bias, rsm, unsigned):
    """The same h from the JAX kernel's epilogue ops (tests/test_ops.py:701-746's oracle)."""
    d = jax.lax.dot_general(jnp.asarray(qa), jnp.asarray(w), (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32).astype(jnp.float32)
    out = d * jnp.asarray(asc).reshape(-1, 1) * jnp.asarray(ws)
    out = out + jnp.dot(jnp.asarray(la).astype(jnp.bfloat16), jnp.asarray(pu), preferred_element_type=jnp.float32)
    g = jgemm._tanh_gelu(out + jnp.asarray(bias).astype(jnp.float32))
    return np.asarray(((g + SHIFT) if unsigned else g) * jnp.asarray(rsm).reshape(1, -1))


@pytest.mark.parametrize("stacked", [False, True])
def test_ptoken_producer_matches_jax(stacked):
    """The per-token producer's twin against ``_gemm_w8a8_gelu_quant_ptoken_kernel``
    (non-stacked, and stacked on layer 2 of 3; act_unsigned_next, N 3072 in
    two 1536-column tiles): qscales (1, M) within 1e-6 relative of JAX's, as
    tests/test_ops.py:701-746 holds the kernel to its oracle; codes equal
    wherever the two epilogues' h is equal (torch's and XLA's tanh may
    differ in the last bit, the only source of a flipped code), and at most
    one apart on at most 0.1% of them elsewhere; lora_next within 1e-3 of
    its max (JAX sums bf16 partials of 1536-column tiles, the twin one f32
    product over all N, as the JAX test's oracle does)."""
    (qa, asc, ws, la, pu, bias, rsm, pd), w_t, w_np = _producer_inputs(70 + stacked)
    layer = 2
    jw = jnp.asarray(w_np) if stacked else jnp.asarray(w_np[layer])
    kw = dict(layer_idx=jnp.int32(layer)) if stacked else {}
    q_ref, s_ref, l_ref = map(np.asarray, jgemm.svdq_gemm_w8a8_gelu_quant(
        *map(_j, (qa, asc)), jw, *map(_j, (ws, la, pu, bias, rsm, pd)), act_unsigned_next=True,
        gelu_shift=SHIFT, ptoken=True, **kw))
    tw = w_t if stacked else w_t[layer]
    tkw = dict(layer_idx=torch.tensor(layer, dtype=torch.int32)) if stacked else {}
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, (qa, asc)), tw, *map(_t, (ws, la, pu, bias, rsm, pd)),
                                              act_unsigned_next=True, ptoken=True, **tkw)
    assert s.shape == s_ref.shape == (1, 128) and q.shape == q_ref.shape and l.shape == l_ref.shape
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-6)
    same_h = _port_h(*map(_t, (qa, asc)), w_t[layer], *map(_t, (ws, la, pu, bias, rsm)), True).numpy() == \
        _jax_h(qa, asc, w_np[layer], ws, la, pu, bias, rsm, True)
    q, q_ref = q.numpy().astype(np.int32), q_ref.astype(np.int32)
    np.testing.assert_array_equal(q[same_h], q_ref[same_h])
    diff = np.abs(q - q_ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    assert _rel(l, l_ref) <= 1e-3


def test_ptoken_is_one_scale_group():
    """The per-token mode is the grouped producer with one scale group of
    all N columns: the same codes and lora_next as the grouped twin at
    bn = N, the scale of each token the max of its groups' scales."""
    (qa, asc, ws, la, pu, bias, rsm, pd), w_t, _ = _producer_inputs(72)
    args = (*map(_t, (qa, asc)), w_t[0], *map(_t, (ws, la, pu, bias, rsm, pd)))
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*args, ptoken=True)
    qg, sg, lg = tgemm.svdq_gemm_w8a8_gelu_quant(*args)
    assert sg.shape == (2, 128) and torch.equal(s[0], sg.amax(dim=0)) and torch.equal(l, lg)
    plain = tgemm.svdq_gemm_w8a8_gelu_quant_plain(*args, ptoken=True)
    assert all(torch.equal(a, b) for a, b in zip((q, s, l), plain))


def test_stacked_producer_matches_jax():
    """The grouped producer's stacked twin on layer 1 of 3 against the
    Pallas kernel's stacked mode (``stacked_w``): the tolerance of the
    non-stacked producer (tests/test_torch_kernels.py): codes at most one
    apart on at most 0.1%, scales within 1e-5, lora_next within 1e-2."""
    (qa, asc, ws, la, pu, bias, rsm, pd), w_t, w_np = _producer_inputs(73)
    q_ref, s_ref, l_ref = map(np.asarray, jgemm.svdq_gemm_w8a8_gelu_quant(
        *map(_j, (qa, asc)), jnp.asarray(w_np), *map(_j, (ws, la, pu, bias, rsm, pd)), gelu_shift=SHIFT,
        layer_idx=jnp.int32(1)))
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, (qa, asc)), w_t, *map(_t, (ws, la, pu, bias, rsm, pd)),
                                              layer_idx=torch.tensor(1, dtype=torch.int32))
    assert s.shape == s_ref.shape == (2, 128)
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5)
    assert _rel(l, l_ref) <= 1e-2


def _consumer_inputs(seed, groups, res, m=128, k=3072, n=256, r=32):
    rng = np.random.default_rng(seed)
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = ((rng.random((groups, m)) + 0.5) / 127.0).astype(np.float32)
    ws = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k))).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    pu = _bf(rng.standard_normal((r, n)) * 0.02)
    bias = _bf(rng.standard_normal((n,)) * 0.02)
    w_t, w_np = _int8_stack(rng, k, n)
    residual = None
    if res:  # the single block's full set: x, gate, the attention output and its low-rank branch
        residual = (_bf(rng.standard_normal((m, n)) * 2.0), (rng.standard_normal((1, n)) * 0.5).astype(np.float32),
                    _bf(rng.standard_normal((m, n)) * 0.5), rng.standard_normal((m, r)).astype(np.float32),
                    _bf(rng.standard_normal((r, n)) * 0.02))
    return (qa, asc, ws, la, pu, bias), residual, w_t, w_np


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("groups", [2, 1], ids=["grouped", "rank1"])
def test_stacked_consumer_matches_jax(groups, res):
    """``svdq_gemm_w4a4(precision="int8", layer_idx=)`` on layer 1 of an (L,
    K 3072, N) stack against JAX's stacked ``_gemm_w8a8_kernel``: grouped
    scales (2 groups of 1536) and per-token scales (the rank-1 mode, which a
    stacked int8 product takes in both packages instead of the XLA dot),
    each with and without the gated-residual epilogue. Without it every
    element within one bf16 step of JAX's: the kernel sums the f32 of each k
    step's int32 partial (rank-1) or scales each group's (grouped) with
    XLA's fused multiply-adds; the twin converts one exact int32 sum
    (rank-1), as the Hopper kernel does; a bf16 output rounds either way at
    most one step. With it the GEMM output is rounded to bf16 before the
    gated add, so one step there moves the result by |gate| steps of it: the
    non-stacked epilogue's bound, 1e-2 of max |ref|
    (tests/test_torch_turbo_ops.py)."""
    (qa, asc, ws, la, pu, bias), residual, w_t, w_np = _consumer_inputs(80 + groups + 2 * res, groups, res)
    ref = jgemm.svdq_gemm_w4a4(*map(_j, (qa, asc)), jnp.asarray(w_np), *map(_j, (ws, la, pu, bias)),
                               precision="int8", layer_idx=jnp.int32(1),
                               residual=None if residual is None else tuple(map(_j, residual)))
    one = torch.tensor(1, dtype=torch.int32)
    out = tgemm.svdq_gemm_w4a4(*map(_t, (qa, asc)), w_t, *map(_t, (ws, la, pu, bias)), precision="int8",
                               layer_idx=one, residual=None if residual is None else tuple(map(_t, residual)))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) <= 1e-2 if res else _bf16_steps(out, ref) == 0


def test_rank1_is_not_the_int_mm_route():
    """The rank-1 mode's epilogue is all f32 (JAX's Pallas kernel), the
    non-stacked per-token product's the XLA route's (main term rounded to
    bf16 before the low-rank add): on the same layer without the low-rank
    term the two agree bit for bit, with it they differ on some elements."""
    (qa, asc, ws, la, pu, bias), _, w_t, _ = _consumer_inputs(84, 1, False)
    a = tuple(map(_t, (qa, asc)))
    w = w_t[2]
    assert torch.equal(tgemm.gemm_w8a8_rank1(*a, w, _t(ws), None, None, _t(bias)),
                       tgemm.gemm_w8a8(*a, w, _t(ws), None, None, _t(bias)))
    assert not torch.equal(tgemm.gemm_w8a8_rank1(*a, w, *map(_t, (ws, la, pu, bias))),
                           tgemm.gemm_w8a8(*a, w, *map(_t, (ws, la, pu, bias))))


def _packed_stack(rng, k, n):
    return np.stack([np.asarray(pack_int4(rng.integers(-8, 8, (k, n)), axis=0)) for _ in range(LAYERS)])


def test_stacked_packed_pair_matches_jax():
    """The packed chain's stacked pair (``NUNCHAKU_TPU_W4A8_FUSED=1`` on a
    scan: the W4 producer and the grouped packed consumer on layer 2 of 3)
    against JAX's stacked ``_gemm_w4a8_gelu_quant_kernel`` and
    ``_gemm_w4a8h_kernel``: the non-stacked packed twins' tolerances
    (tests/test_torch_w4a8_packed.py): producer codes at most one apart on
    at most 0.1%, scales within 1e-5, lora_next within 1e-2; the consumer
    (on the JAX producer's outputs) within one bf16 step on every element."""
    rng = np.random.default_rng(90)
    m, k, n, r = 128, 512, 3072, 32
    qa = rng.integers(-127, 128, (m, k), dtype=np.int8)
    asc = ((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32)
    qw1, qw2 = _packed_stack(rng, k, n), _packed_stack(rng, n, k)
    rs1 = _bf(rng.random((k // 64, n)) * (127.0 / 7.0 - 1.0) + 1.0)
    rs2 = _bf(rng.random((n // 64, k)) * (127.0 / 7.0 - 1.0) + 1.0)
    ws1 = ((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k) * 8.0)).astype(np.float32)
    ws2 = ((rng.random((1, k)) + 0.5) / (73.0 * np.sqrt(n) * 8.0)).astype(np.float32)
    la = rng.standard_normal((m, r)).astype(np.float32)
    pu1, pu2 = _bf(rng.standard_normal((r, n)) * 0.02), _bf(rng.standard_normal((r, k)) * 0.02)
    b1, b2 = _bf(rng.standard_normal((n,)) * 0.02), _bf(rng.standard_normal((k,)) * 0.02)
    rsm = (rng.random((n,)) + 0.5).astype(np.float32)
    pd = _bf(rng.standard_normal((n, r)) * 0.02)
    jidx, tidx = jnp.int32(2), torch.tensor(2, dtype=torch.int32)
    q_ref, s_ref, l_ref = jgemm.svdq_gemm_w8a8_gelu_quant(
        *map(_j, (qa, asc, qw1, ws1, la, pu1, b1, rsm, pd)), gelu_shift=SHIFT, layer_idx=jidx,
        rescales=jnp.asarray(rs1), precision="w4a8")
    q, s, l = tgemm.svdq_gemm_w8a8_gelu_quant(*map(_t, (qa, asc, qw1, ws1, la, pu1, b1, rsm, pd)), layer_idx=tidx,
                                              rescales=_t(rs1), precision="w4a8")
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_ref).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5)
    assert s.shape == (2, m) and _rel(l, l_ref) <= 1e-2
    ref = jgemm.svdq_gemm_w4a4(q_ref, s_ref, jnp.asarray(qw2), jnp.asarray(ws2), l_ref, *map(_j, (pu2, b2)),
                               rescales=jnp.asarray(rs2), precision="w4a8", layer_idx=jidx)
    out = tgemm.svdq_gemm_w4a4(*map(_t, (q_ref, s_ref, qw2, ws2, l_ref, pu2, b2, rs2)), precision="w4a8",
                               layer_idx=tidx)
    assert out.dtype == torch.bfloat16 and _bf16_steps(out, ref) == 0


STACK_MODES = ["producer", "ptoken", "grouped", "grouped_res", "rank1", "rank1_res", "w4_producer", "w4_grouped"]


@pytest.mark.parametrize("mode", STACK_MODES)
def test_stacked_twin_is_the_layer_twin(mode):
    """On every layer i >= 1 of a 3-layer stack, each stacked twin gives the
    non-stacked twin's outputs on ``qweight[i]`` bit for bit (the kernels
    take the same promise on the card: tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(100 + STACK_MODES.index(mode))
    m, k, n, r = 128, 512, 1024, 16
    qa = _t(rng.integers(-127, 128, (m, k), dtype=np.int8))
    asc = _t(((rng.random((1, m)) + 0.5) / 127.0).astype(np.float32))
    la = _t(rng.standard_normal((m, r)).astype(np.float32))
    pu, bias = _t(_bf(rng.standard_normal((r, n)) * 0.02)), _t(_bf(rng.standard_normal((n,)) * 0.02))
    ws = _t(((rng.random((1, n)) + 0.5) / (73.0 * np.sqrt(k))).astype(np.float32))
    rsm, pd = _t((rng.random((n,)) + 0.5).astype(np.float32)), _t(_bf(rng.standard_normal((n, r)) * 0.02))
    res = (_t(_bf(rng.standard_normal((m, n)))), _t(rng.standard_normal((1, n)).astype(np.float32)))
    gasc = _t(((rng.random((2, m)) + 0.5) / 127.0).astype(np.float32))
    w8, _ = _int8_stack(rng, k, n)
    w4 = _t(_packed_stack(rng, k, n))
    rs = _t(_bf(rng.random((k // 64, n)) * (127.0 / 7.0 - 1.0) + 1.0))
    calls = {
        "producer": lambda w, **kw: tgemm.svdq_gemm_w8a8_gelu_quant(qa, asc, w8 if kw else w, ws, la, pu, bias, rsm,
                                                                    pd, **kw),
        "ptoken": lambda w, **kw: tgemm.svdq_gemm_w8a8_gelu_quant(qa, asc, w8 if kw else w, ws, la, pu, bias, rsm,
                                                                  pd, ptoken=True, **kw),
        "grouped": lambda w, **kw: tgemm.gemm_w8a8_grouped(qa, gasc, w8 if kw else w, ws, la, pu, bias, **kw),
        "grouped_res": lambda w, **kw: tgemm.gemm_w8a8_grouped(qa, gasc, w8 if kw else w, ws, la, pu, bias, res,
                                                               **kw),
        "rank1": lambda w, **kw: tgemm.gemm_w8a8_rank1(qa, asc, w8 if kw else w, ws, la, pu, bias, **kw),
        "rank1_res": lambda w, **kw: tgemm.gemm_w8a8_rank1(qa, asc, w8 if kw else w, ws, la, pu, bias, res, **kw),
        "w4_producer": lambda w, **kw: tgemm.svdq_gemm_w4a8_gelu_quant(qa, asc, w4 if kw else w, rs, ws, la, pu,
                                                                       bias, rsm, pd, **kw),
        "w4_grouped": lambda w, **kw: tgemm.gemm_w4a8_grouped(qa, gasc, w4 if kw else w, rs, ws, la, pu, bias, **kw),
    }
    stack = w4 if mode.startswith("w4") else w8
    for i in range(1, LAYERS):
        got = calls[mode](None, layer_idx=torch.tensor(i, dtype=torch.int32))
        want = calls[mode](stack[i])
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (mode, i)
    with pytest.raises(IndexError):
        calls[mode](None, layer_idx=torch.tensor(LAYERS, dtype=torch.int32))


def test_chain_ptoken_switch_read_at_call_time(monkeypatch):
    """``NUNCHAKU_TPU_CHAIN_PTOKEN`` under the JAX name and default (off),
    read at each call."""
    monkeypatch.delenv("NUNCHAKU_TPU_CHAIN_PTOKEN", raising=False)
    assert not tgemm.chain_ptoken() and tgemm.chain_ptoken() == jgemm._chain_ptoken()
    monkeypatch.setenv("NUNCHAKU_TPU_CHAIN_PTOKEN", "1")
    assert tgemm.chain_ptoken() and tgemm.chain_ptoken() == jgemm._chain_ptoken()
    monkeypatch.setenv("NUNCHAKU_TPU_CHAIN_PTOKEN", "0")
    assert not tgemm.chain_ptoken()
