"""Kernel-versus-plain checks on the card, shared by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Each ``*_case`` builds seeded inputs for one kernel at given shapes, with
magnitudes like the FLUX path's (int8 codes over the full range, scales
that bring the GEMM outputs to O(1) where GELU bends). Each ``check_*``
runs the kernel wrapper and its plain twin on the same inputs and returns
``(max_abs_err, ok, detail)`` against the tolerance stated in its
docstring. The checks' own launches are no part of a main-path count:
callers reset the counts before driving the path.
"""

from __future__ import annotations

import math

import torch

from .attention import (
    BS_TILE,
    LOG2E,
    ONLINE_BKV,
    block_sparse_attention,
    block_sparse_fixed_plain,
    block_sparse_online_plain,
    flash_attention,
    flash_attention_bshd,
    flash_attention_bshd_plain,
    flash_attention_denom,
    flash_attention_denom_plain,
    flash_attention_i8,
    flash_attention_i8_plain,
    flash_attention_online,
    flash_attention_online_plain,
    flash_attention_plain,
    flash_attention_unroll2,
    flash_attention_unroll2_plain,
    qkv_prepare,
    qkv_prepare_plain,
    qkv_rope_producer,
    qkv_rope_producer_plain,
    quantize_qk,
    select_blocks,
)
from .gemm import (
    chain_h_plain,
    chain_tile_n,
    dequant_w4a8,
    dequant_w4a8_plain,
    gemm_w4a4,
    gemm_w4a4_plain,
    gemm_w4a8,
    gemm_w4a8_grouped,
    gemm_w4a8_plain,
    gemm_w8a8_grouped,
    gemm_w8a8_grouped_plain,
    gemm_w8a8_grouped_res,
    gemm_w8a8_rank1,
    svdq_gemm_w4a8_gelu_quant,
    svdq_gemm_w4a8_gelu_quant_plain,
    svdq_gemm_w8a8_gelu_quant,
    svdq_gemm_w8a8_gelu_quant_plain,
    w4a8_group,
)
from .gemm_probe import (I8_TILES, decode_operand, gemm_probe_bf16, gemm_probe_bf16_plain, gemm_probe_i8,
                         gemm_probe_i8_plain)
from .quantize import rcp
from .gemv import awq_w4a16_linear, awq_w4a16_linear_plain
from .quantize import ln_mod_quant_int8, ln_mod_quant_int8_dual, ln_mod_quant_int8_dual_plain, ln_mod_quant_int8_plain
from .reference import group_size


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _rel(x: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = (x.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def dequant_case(k, n, *, codes="int4", seed=0, device="cuda"):
    """Random packed codes (every nibble: e2m1 meets the stray code -8 too)
    and bf16 rescales in [1, 127 / max |value|] per group of 64 (int4) or
    16 (e2m1) rows, as the w4a8 conversion makes them."""
    g = _gen(seed, device)
    qw = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=device, generator=g)
    cmax = 6.0 if codes == "e2m1" else 7.0
    rs = torch.rand((k // w4a8_group(codes), n), device=device, generator=g) * (127.0 / cmax - 1.0) + 1.0
    return qw, rs.to(torch.bfloat16)


def gelu_quant_case(m, k, n, r=32, *, seed=0, device="cuda"):
    g = _gen(seed, device)
    qa = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    ascales = (torch.rand((1, m), device=device, generator=g) + 0.5) / 127.0
    # the (K, N) weight K-contiguous, as the dequant kernel writes it
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=device, generator=g).t()
    wscales = (torch.rand((1, n), device=device, generator=g) + 0.5) / (73.0 * math.sqrt(k))
    la = torch.randn((m, r), device=device, generator=g)
    pu = (torch.randn((r, n), device=device, generator=g) * 0.02).to(torch.bfloat16)
    bias = (torch.randn((n,), device=device, generator=g) * 0.02).to(torch.bfloat16)
    rsm = torch.rand((n,), device=device, generator=g) + 0.5
    pd = (torch.randn((n, r), device=device, generator=g) * 0.02).to(torch.bfloat16)
    return qa, ascales, w, wscales, la, pu, bias, rsm, pd


def grouped_case(m, k, n, groups, r=32, *, seed=0, device="cuda"):
    qa, _, w, wscales, la, pu, bias, _, _ = gelu_quant_case(m, k, n, r, seed=seed, device=device)
    g = _gen(seed + 1, device)
    ascales = (torch.rand((groups, m), device=device, generator=g) + 0.5) / 127.0
    return qa, ascales, w, wscales, la, pu, bias


def w4a8_case(m, k, n, r=32, *, seed=0, device="cuda"):
    """Operands of the packed w4a8 GEMM in rank-1 mode, (qact, ascales (1,
    M), qweight, rescales, wscales, lora_act, proj_up, bias):
    gelu_quant_case's activations, scales, low-rank terms and bias with
    dequant_case's packed codes (every nibble) and rescales."""
    qa, asc, _, ws, la, pu, bias, _, _ = gelu_quant_case(m, k, n, r, seed=seed, device=device)
    qw, rs = dequant_case(k, n, seed=seed + 3, device=device)
    return qa, asc, qw, rs, ws, la, pu, bias


def w4a8_grouped_case(m, k, n, groups, r=32, *, seed=0, device="cuda"):
    """w4a8_case with (groups, M) activation scales: the packed chain
    consumer's operands."""
    qa, _, qw, rs, ws, la, pu, bias = w4a8_case(m, k, n, r, seed=seed, device=device)
    asc = (torch.rand((groups, m), device=device, generator=_gen(seed + 1, device)) + 0.5) / 127.0
    return qa, asc, qw, rs, ws, la, pu, bias


def w4a8_gelu_quant_case(m, k, n, r=32, *, seed=0, device="cuda"):
    """gelu_quant_case with the weight as packed int4 codes and rescales:
    (qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias,
    rsmooth_next, proj_down_next)."""
    qa, asc, _, ws, la, pu, bias, rsm, pd = gelu_quant_case(m, k, n, r, seed=seed, device=device)
    qw, rs = dequant_case(k, n, seed=seed + 3, device=device)
    return qa, asc, qw, rs, ws, la, pu, bias, rsm, pd


def flash_case(b, h, sq, skv, d=128, *, seed=0, device="cuda"):
    g = _gen(seed, device)
    # q carries softmax-scale * log2(e) like the FLUX path's prescaled q
    q = (torch.randn((b, h, sq, d), device=device, generator=g) * (1.4426950408889634 / math.sqrt(d)) * 2.0)
    k = torch.randn((b, h, skv, d), device=device, generator=g) * 2.0
    v = torch.randn((b, h, skv, d), device=device, generator=g)
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)


def flash_masked_case(b, h, s_txt, s_img, valid, d=128, *, seed=0, device="cuda"):
    """flash_case's q, k, v over a joint [txt; img] sequence and a (B, S)
    bool padded-prompt mask: batch row i keeps its first ``valid[i]`` text
    keys and every image key."""
    s = s_txt + s_img
    q, k, v = flash_case(b, h, s, s, d, seed=seed, device=device)
    mask = torch.ones((b, s), dtype=torch.bool, device=device)
    for i, n in enumerate(valid):
        mask[i, n:s_txt] = False
    return q, k, v, mask


def run_flash_masked(q, k, v, mask, online, plain=False):
    """The fixed-shift (``online`` False) or online flash with a kv mask, or
    its plain twin, as the attention module calls it: q prescaled, (B, S,
    H*D) out."""
    if online:
        fn = flash_attention_online_plain if plain else flash_attention_online
        return fn(q, k, v, scale=1.0, kv_mask=mask, out_bshd=True)
    return (flash_attention_plain if plain else flash_attention)(q, k, v, mask)


def check_flash_masked(q, k, v, mask, online=False):
    """bf16 (B, S, H*D) output: max error <= 1e-2 of the plain twin's max
    |value|. Also: an all-True mask gives the unmasked kernel's output bit
    for bit; v made huge (1e4) at the masked columns changes no output bit
    (p = 0 exactly); each batch row within 1e-2 of the kernel over that
    row's unmasked keys alone."""
    out = run_flash_masked(q, k, v, mask, online)
    ref = run_flash_masked(q, k, v, mask, online, plain=True)
    err, rel = _rel(out, ref)
    ones = torch.ones_like(mask)
    same_ones = torch.equal(run_flash_masked(q, k, v, ones, online), run_flash_masked(q, k, v, None, online))
    v_big = v.clone()
    v_big.transpose(1, 2)[~mask] = 1e4
    same_big = torch.equal(run_flash_masked(q, k, v_big, mask, online), out)
    alone = 0.0
    for i in range(q.shape[0]):
        keep = mask[i]
        o = run_flash_masked(q[i:i + 1], k[i:i + 1, :, keep], v[i:i + 1, :, keep], None, online)
        alone = max(alone, _rel(out[i:i + 1], o)[1])
    ok = (rel <= 1e-2 and alone <= 1e-2 and same_ones and same_big and out.shape == ref.shape
          and bool(torch.isfinite(out.float()).all()))
    return err, ok, (f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2); rows vs their unmasked keys alone rel "
                     f"{alone:.2e} (tol 1e-2); all-True mask == no mask: {same_ones}; huge v at masked "
                     f"columns changes nothing: {same_big}")


def block_sparse_case(b, h, s, sparsity, *, bq=768, bkv=1536, seed=0, device="cuda"):
    """flash_case's prescaled q, k, v over S tokens, bq / bkv shrunk as
    block_sparse_attention shrinks them, and select_blocks' ids at
    ``sparsity`` -> (q, k, v, block_idx, bq, bkv)."""
    q, k, v = flash_case(b, h, s, s, seed=seed, device=device)
    bq, bkv = (min(x, -(-s // BS_TILE) * BS_TILE) for x in (bq, bkv))
    return q, k, v, select_blocks(q, k, sparsity, bq=bq, bkv=bkv), bq, bkv


def run_block_sparse(q, k, v, block_idx, bq, bkv, fixed, out_bshd=True, plain=False):
    """A block-sparse kernel (fixed-shift or online), or its plain twin, as
    the FLUX route calls it: q prescaled (scale 1.0)."""
    if plain:
        twin = block_sparse_fixed_plain if fixed else block_sparse_online_plain
        return twin(q, k, v, block_idx, scale=1.0, bq=bq, bkv=bkv, out_bshd=out_bshd)
    return block_sparse_attention(q, k, v, sparsity_ratio=0.0, scale=1.0, block_idx=block_idx, bq=bq, bkv=bkv,
                                  out_bshd=out_bshd, fixed_softmax=fixed)


def check_block_sparse(q, k, v, block_idx, bq, bkv, fixed, out_bshd=True):
    """bf16 output: max error <= 1e-2 of the plain twin's max |value|
    (the online twin takes the kernel's 128-column rescale steps). Also
    exact: with every kv block selected the kernel walks the dense kernel's
    tiles in the dense kernel's order, so its output equals the dense flash
    kernel's (same softmax form) bit for bit."""
    out = run_block_sparse(q, k, v, block_idx, bq, bkv, fixed, out_bshd)
    ref = run_block_sparse(q, k, v, block_idx, bq, bkv, fixed, out_bshd, plain=True)
    err, rel = _rel(out, ref)
    b, h, sq, d = q.shape
    nk = -(-k.shape[2] // bkv)
    every = torch.arange(nk, dtype=torch.int32, device=q.device).expand(b, h, -(-sq // bq), nk).contiguous()
    full = run_block_sparse(q, k, v, every, bq, bkv, fixed, out_bshd=True)
    dense = flash_attention(q, k, v) if fixed else flash_attention_online(q, k, v, scale=1.0, out_bshd=True)
    same = torch.equal(full, dense)
    ok = rel <= 1e-2 and same and out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    return err, ok, (f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2); every block selected == dense kernel: {same}")


def flash_online_case(b, h, sq, skv, d=512, *, seed=0, device="cuda"):
    """Unscaled q, k, v with logits q . k / sqrt(D) of std ~4: the running
    max moves over the kv tiles and p spans many binades."""
    g = _gen(seed, device)
    q = torch.randn((b, h, sq, d), device=device, generator=g) * 2.0
    k = torch.randn((b, h, skv, d), device=device, generator=g) * 2.0
    v = torch.randn((b, h, skv, d), device=device, generator=g)
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)


def ln_mod_quant_case(b, s, k, r=32, *, mod=True, seed=0, device="cuda"):
    """A (B, S, K) bf16 stream with a spread of row means and scales; the
    modulation as two (B, K) chunks of one (B, 6K) AdaLN vector, like the
    model passes them."""
    g = _gen(seed, device)
    x = (torch.randn((b, s, k), device=device, generator=g) * 4.0
         + torch.randn((b, s, 1), device=device, generator=g)).to(torch.bfloat16)
    sc = sh = None
    if mod:
        vec = torch.randn((b, 6 * k), device=device, generator=g) * 0.3
        sh, sc = vec.chunk(6, dim=-1)[:2]
    smooth = (torch.rand((k,), device=device, generator=g) * 1.5 + 0.5).to(torch.bfloat16)
    pd = (torch.randn((k, r), device=device, generator=g) * 0.02).to(torch.bfloat16)
    return x, sc, sh, smooth, pd


def qkv_rope_case(b, seqs, heads, d=128, r=32, *, seed=0, device="cuda"):
    """Streams that fill one joint (B, H, sum(seqs), D) buffer set: the
    dual block's (S_txt, S_img), or a single block's (S,). Returns
    (streams, cos, sin) with streams a list of (qkv, norm_q, norm_k,
    lora_act, proj_up, row offset), last stream first (the model's call
    order); ``r = 0`` leaves out the low-rank term."""
    g = _gen(seed, device)
    n3 = 3 * heads * d
    s_all = sum(seqs)
    ang = torch.rand((s_all, d // 2), device=device, generator=g) * 6.0
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1).contiguous()
    sin = torch.cat([-torch.sin(ang), torch.sin(ang)], dim=-1).contiguous()
    streams, off = [], 0
    for s in seqs:
        qkv = (torch.randn((b, s, n3), device=device, generator=g) * 2.0).to(torch.bfloat16)
        nq = (torch.rand((d,), device=device, generator=g) + 0.5).to(torch.bfloat16)
        nk = (torch.rand((d,), device=device, generator=g) + 0.5).to(torch.bfloat16)
        la = pu = None
        if r:
            la = torch.randn((b, s, r), device=device, generator=g)
            pu = (torch.randn((r, n3), device=device, generator=g) * 0.05).to(torch.bfloat16)
        streams.append((qkv, nq, nk, la, pu, off))
        off += s
    return streams[::-1], cos, sin


def grouped_res_case(m, k, n, groups, r=32, *, batch=1, extra=True, seed=0, device="cuda"):
    """grouped_case's operands plus the residual (x, gate[, extra, extra_la,
    extra_pu]) of a batch of ``batch`` streams of M / batch rows."""
    args = grouped_case(m, k, n, groups, r, seed=seed, device=device)
    g = _gen(seed + 2, device)
    x = (torch.randn((m, n), device=device, generator=g) * 2.0).to(torch.bfloat16)
    gate = torch.randn((batch, n), device=device, generator=g) * 0.5
    res = (x, gate)
    if extra:
        ex = (torch.randn((m, n), device=device, generator=g) * 0.5).to(torch.bfloat16)
        ela = torch.randn((m, r), device=device, generator=g)
        epu = (torch.randn((r, n), device=device, generator=g) * 0.02).to(torch.bfloat16)
        res = res + (ex, ela, epu)
    return args + (res,)


def w4a4_case(m, k, n, precision="int4", act_unsigned=False, r=32, *, seed=0, device="cuda"):
    """Random 4-bit codes on both sides (every nibble, so nvfp4 meets the
    stray code -8 too) with group scales that bring the outputs to O(1); the
    weight stored K-contiguous, as ``SVDQW4A4Linear`` keeps it. Returns the
    positional operands of :func:`~.gemm.gemm_w4a4` and its keywords."""
    g = _gen(seed, device)
    gs = group_size(precision)
    qa = torch.randint(-128, 128, (m, k // 2), dtype=torch.int8, device=device, generator=g)
    qw = torch.randint(-128, 128, (n, k // 2), dtype=torch.int8, device=device, generator=g).t()
    asc = ((torch.rand((k // gs, m), device=device, generator=g) + 0.5) / 4.6).to(torch.bfloat16)
    wsc = ((torch.rand((k // gs, n), device=device, generator=g) + 0.5) / (4.6 * math.sqrt(k))).to(torch.bfloat16)
    la = torch.randn((m, r), device=device, generator=g)
    pu = (torch.randn((r, n), device=device, generator=g) * 0.02).to(torch.bfloat16)
    bias = (torch.randn((n,), device=device, generator=g) * 0.02).to(torch.bfloat16)
    return (qa, asc, qw, wsc, la, pu, bias), dict(precision=precision, act_unsigned=act_unsigned)


def awq_case(m, k, n, *, seed=0, device="cuda"):
    """bf16 activations and an AWQ weight with the JAX ``random_init``
    distributions: (x, qweight, wscales, wzeros, bias)."""
    g = _gen(seed, device)
    std = 1.0 / math.sqrt(k)
    x = torch.randn((m, k), device=device, generator=g).to(torch.bfloat16)
    qw = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=device, generator=g)
    ws = (torch.randn((k // 64, n), device=device, generator=g).abs() * std / 8).to(torch.bfloat16)
    wz = (torch.randn((k // 64, n), device=device, generator=g) * std).to(torch.bfloat16)
    bias = (torch.randn((n,), device=device, generator=g) * 0.02).to(torch.bfloat16)
    return x, qw, ws, wz, bias


def check_w4a4(args, kw):
    """bf16 output: every element within one bf16 rounding step of the plain
    output (|err| <= 2^-7 |ref|) plus 1e-4 of max |ref| for sums that
    cancel: the same bf16 operands and products, f32 sums in another order."""
    out = gemm_w4a4(*args, **kw)
    ref = gemm_w4a4_plain(*args, **kw)
    err, rel = _rel(out, ref)
    o, r = out.float(), ref.float()
    beyond = ((o - r).abs() > 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()).sum().item()
    ok = beyond == 0 and out.shape == ref.shape and bool(torch.isfinite(o).all())
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e}; {beyond} elements beyond one bf16 step (tol 0)"


def check_awq(x, qw, ws, wz, bias):
    """f32 output: max error <= 1e-4 of the plain output's max |value| (the
    same bf16 weights, f32 sums in another order)."""
    out = awq_w4a16_linear(x, qw, ws, wz, bias)
    ref = awq_w4a16_linear_plain(x, qw, ws, wz, bias)
    err, rel = _rel(out, ref)
    ok = rel <= 1e-4 and out.shape == ref.shape and bool(torch.isfinite(out).all())
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-4)"


def check_dequant(qw, rs, codes="int4"):
    """Exact: every int8 code equals the plain version's."""
    out = dequant_w4a8(qw, rs, codes)
    ref = dequant_w4a8_plain(qw, rs, codes)
    err = (out.int() - ref.int()).abs().max().item()
    return float(err), err == 0, f"max code diff {err} (tolerance: exact)"


STACK_LAYERS = 3  # layers of the stacks the stacked-mode checks build


def stack_case(weight: torch.Tensor, layers: int = STACK_LAYERS, *, seed=7):
    """An (L, ...) stack of random bytes (packed (K/2, N) codes or (K, N)
    int8 weights) whose every layer has ``weight``'s shape and layout (a
    K-contiguous weight gives a stack of K-contiguous layers, back to back),
    with ``weight`` itself as its last layer; -> (stack, one 0-d int32 index
    tensor per layer, on the weight's device)."""
    half, n = weight.shape
    g = _gen(seed, weight.device)
    if weight.is_contiguous():
        stack = torch.randint(-128, 128, (layers, half, n), dtype=torch.int8, device=weight.device, generator=g)
    else:
        stack = torch.randint(-128, 128, (layers, n, half), dtype=torch.int8, device=weight.device,
                              generator=g).transpose(1, 2)
    stack[-1].copy_(weight)
    ids = torch.arange(layers, dtype=torch.int32, device=weight.device)
    return stack, [ids[i] for i in range(layers)]


def _stacked_report(stacked_same, err, ok, detail):
    same = all(stacked_same)
    return err, ok and same, f"{detail}; stacked == non-stacked kernel on each of {len(stacked_same)} layers: {same}"


def check_w4a4_stacked(args, kw):
    """The W4A4 kernel's stacked mode on a :func:`stack_case` stack of the
    case's weight: on every layer bit for bit the non-stacked kernel on
    that layer (the same code, only the weight pointer moved), and on the
    case's weight (the last layer) :func:`check_w4a4`'s tolerance against
    the plain twin."""
    qa, asc, qw, wsc = args[:4]
    stack, ids = stack_case(qw)
    same = [torch.equal(gemm_w4a4(qa, asc, stack, wsc, *args[4:], **kw, layer_idx=i),
                        gemm_w4a4(qa, asc, stack[l], wsc, *args[4:], **kw)) for l, i in enumerate(ids)]
    out = gemm_w4a4(qa, asc, stack, wsc, *args[4:], **kw, layer_idx=ids[-1])
    ref = gemm_w4a4_plain(*args, **kw)
    err, rel = _rel(out, ref)
    o, r = out.float(), ref.float()
    beyond = ((o - r).abs() > 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()).sum().item()
    ok = beyond == 0 and out.shape == ref.shape and bool(torch.isfinite(o).all())
    return _stacked_report(same, err, ok,
                           f"max abs {err:.3e}, rel {rel:.2e}; {beyond} elements beyond one bf16 step (tol 0)")


def check_dequant_stacked(qw, rs, codes="int4", layers=STACK_LAYERS):
    """The dequant's stacked mode: exact codes on the case's weight (the
    last layer of a :func:`stack_case` stack of ``layers``), and on every
    layer the non-stacked kernel's codes bit for bit."""
    stack, ids = stack_case(qw, layers)
    same = [torch.equal(dequant_w4a8(stack, rs, codes, layer_idx=i), dequant_w4a8(stack[l], rs, codes))
            for l, i in enumerate(ids)]
    out = dequant_w4a8(stack, rs, codes, layer_idx=ids[-1])
    err = (out.int() - dequant_w4a8_plain(qw, rs, codes).int()).abs().max().item()
    return _stacked_report(same, float(err), err == 0, f"max code diff {err} (tolerance: exact)")


def check_w4a8_stacked(qa, ascales, qw, rs, wscales, la, pu, bias):
    """The packed GEMM's stacked rank-1 mode: on every layer of a
    :func:`stack_case` stack bit for bit the non-stacked kernel on that
    layer, and on the case's weight (the last layer) within one bf16 step of
    the plain twin (bit for bit without the low-rank term)."""
    stack, ids = stack_case(qw)
    rest = (rs, wscales, la, pu, bias)
    same = [torch.equal(gemm_w4a8(qa, ascales, stack, *rest, layer_idx=i), gemm_w4a8(qa, ascales, stack[l], *rest))
            for l, i in enumerate(ids)]
    out = gemm_w4a8(qa, ascales, stack, *rest, layer_idx=ids[-1])
    ref = gemm_w4a8_plain(qa, ascales, qw, *rest)
    err, rel = _rel(out, ref)
    o, r = out.float(), ref.float()
    beyond = ((o - r).abs() > 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()).sum().item()
    exact = torch.equal(gemm_w4a8(qa, ascales, stack, rs, wscales, None, None, bias, layer_idx=ids[-1]),
                        gemm_w4a8_plain(qa, ascales, qw, rs, wscales, None, None, bias))
    ok = beyond == 0 and exact and out.shape == ref.shape and bool(torch.isfinite(o).all())
    return _stacked_report(same, err, ok, f"max abs {err:.3e}, rel {rel:.2e}; {beyond} elements beyond "
                           f"one bf16 step (tol 0); no low-rank == twin: {exact}")


def check_gelu_quant(qa, ascales, w, wscales, la, pu, bias, rsm, pd, act_unsigned_next=False):
    """Codes: at most one code apart, on at most 0.1% of elements; scales:
    relative error <= 1e-5; lora_next: max error <= 1e-2 of its max |value|."""
    kw = dict(act_unsigned_next=act_unsigned_next)
    q, s, l = svdq_gemm_w8a8_gelu_quant(qa, ascales, w, wscales, la, pu, bias, rsm, pd, **kw)
    qr, sr, lr = svdq_gemm_w8a8_gelu_quant_plain(qa, ascales, w, wscales, la, pu, bias, rsm, pd, **kw)
    diff = (q.int() - qr.int()).abs()
    code_max = diff.max().item()
    frac = (diff > 0).float().mean().item()
    s_rel = ((s - sr).abs() / sr.abs().clamp_min(1e-30)).max().item()
    _, l_rel = _rel(l, lr)
    ok = (code_max <= 1 and frac <= 1e-3 and s_rel <= 1e-5 and l_rel <= 1e-2
          and q.shape == qr.shape and s.shape == sr.shape == (w.shape[1] // chain_tile_n(w.shape[1]), qa.shape[0]))
    detail = (f"max code diff {code_max} on {frac:.2e} of codes (tol 1 on <=1e-3); "
              f"scale rel {s_rel:.2e} (tol 1e-5); lora_next rel {l_rel:.2e} (tol 1e-2)")
    return float(code_max), ok, detail


def check_w4a8(qa, ascales, qw, rs, wscales, la, pu, bias):
    """The packed GEMM (rank-1 mode for (1, M) ascales, else grouped), bf16
    output. Against the plain twin: every element within one bf16 step
    (|err| <= 2^-7 |ref| + 1e-4 max |ref|: the low-rank term's f32 sum in
    another order); without the low-rank term bit for bit (the same exact
    int32 products, then the same f32 scale, group-sum and bias steps).
    And bit for bit the int8 grouped kernel on the dequant kernel's weight:
    the same values, the same epilogue (the two routes of the chain), where
    that kernel takes the shape (M % 128 == 0)."""
    fn = gemm_w4a8 if ascales.shape[0] == 1 else gemm_w4a8_grouped
    out = fn(qa, ascales, qw, rs, wscales, la, pu, bias)
    ref = gemm_w4a8_plain(qa, ascales, qw, rs, wscales, la, pu, bias)
    err, rel = _rel(out, ref)
    o, r = out.float(), ref.float()
    beyond = ((o - r).abs() > 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()).sum().item()
    exact = torch.equal(fn(qa, ascales, qw, rs, wscales, None, None, bias),
                        gemm_w4a8_plain(qa, ascales, qw, rs, wscales, None, None, bias))
    same = qa.shape[0] % 128 != 0 or torch.equal(
        out, gemm_w8a8_grouped(qa, ascales, dequant_w4a8(qw, rs), wscales, la, pu, bias))
    ok = beyond == 0 and exact and same and out.shape == ref.shape and bool(torch.isfinite(o).all())
    return err, ok, (f"max abs {err:.3e}, rel {rel:.2e}; {beyond} elements beyond one bf16 step (tol 0); "
                     f"no low-rank == twin: {exact}; == int8 grouped kernel on the dequantized weight: {same}")


def check_w4a8_gelu_quant(qa, ascales, qw, rs, wscales, la, pu, bias, rsm, pd, act_unsigned_next=False):
    """The W4 producer against its plain twin with check_gelu_quant's
    tolerances, and bit for bit (codes, scales, lora_next) the int8
    producer kernel on the dequant kernel's weight."""
    kw = dict(act_unsigned_next=act_unsigned_next)
    q, s, l = svdq_gemm_w4a8_gelu_quant(qa, ascales, qw, rs, wscales, la, pu, bias, rsm, pd, **kw)
    qr, sr, lr = svdq_gemm_w4a8_gelu_quant_plain(qa, ascales, qw, rs, wscales, la, pu, bias, rsm, pd, **kw)
    diff = (q.int() - qr.int()).abs()
    code_max = diff.max().item()
    frac = (diff > 0).float().mean().item()
    s_rel = ((s - sr).abs() / sr.abs().clamp_min(1e-30)).max().item()
    _, l_rel = _rel(l, lr)
    int8 = svdq_gemm_w8a8_gelu_quant(qa, ascales, dequant_w4a8(qw, rs), wscales, la, pu, bias, rsm, pd, **kw)
    same = all(torch.equal(a, b) for a, b in zip((q, s, l), int8))
    ok = (code_max <= 1 and frac <= 1e-3 and s_rel <= 1e-5 and l_rel <= 1e-2 and same
          and q.shape == qr.shape and s.shape == sr.shape == (qw.shape[1] // chain_tile_n(qw.shape[1]), qa.shape[0]))
    detail = (f"max code diff {code_max} on {frac:.2e} of codes (tol 1 on <=1e-3); scale rel {s_rel:.2e} (tol "
              f"1e-5); lora_next rel {l_rel:.2e} (tol 1e-2); == int8 producer on the dequantized weight: {same}")
    return float(code_max), ok, detail


def check_grouped(qa, ascales, w, wscales, la, pu, bias):
    """bf16 output: max error <= 1e-2 of the plain output's max |value|."""
    out = gemm_w8a8_grouped(qa, ascales, w, wscales, la, pu, bias)
    ref = gemm_w8a8_grouped_plain(qa, ascales, w, wscales, la, pu, bias)
    err, rel = _rel(out, ref)
    return err, rel <= 1e-2 and out.shape == ref.shape, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2)"


def check_flash(q, k, v):
    """bf16 output: max error <= 1e-2 of the plain output's max |value|."""
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    err, rel = _rel(out, ref)
    ok = rel <= 1e-2 and out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2)"


def by_heads(fn, q, k, v, heads=4):
    """``fn(q, k, v)`` -> a tuple of (B, H, ...) outputs, run over groups of
    ``heads`` heads and concatenated along dim 1: a plain twin's (Sq, Skv)
    f32 scores at FLUX's 2048px S (1.1 GiB a head) held a few heads at a
    time."""
    parts = [fn(q[:, i:i + heads], k[:, i:i + heads], v[:, i:i + heads]) for i in range(0, q.shape[1], heads)]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def check_flash_denom(q, k, v):
    """Prescaled q (scale 1): o (B, H, S, D) bf16 within 1e-2 of the plain
    twin's max |value|, l within 1e-5 relative (f32 sums in another order);
    and o bit for bit the one-tile kernel's output (the same loop, the logits
    times exactly 1)."""
    o, l = flash_attention_denom(q, k, v, scale=1.0)
    ref_o, ref_l = by_heads(lambda *a: flash_attention_denom_plain(*a, scale=1.0), q, k, v)
    err, rel = _rel(o, ref_o)
    l_rel = ((l - ref_l).abs().max() / ref_l.abs().max()).item()
    b, h, sq, d = q.shape
    same = torch.equal(o.transpose(1, 2).reshape(b, sq, h * d), flash_attention(q, k, v))
    ok = (rel <= 1e-2 and l_rel <= 1e-5 and same and o.shape == ref_o.shape and l.shape == ref_l.shape
          and bool(torch.isfinite(o.float()).all()))
    return err, ok, (f"o max abs {err:.3e}, rel {rel:.2e} (tol 1e-2); l rel {l_rel:.2e} (tol 1e-5); "
                     f"o == flash_fixed's: {same}")


def ring_shards(q, k, v, n):
    """The ring attention's arithmetic in one process: the denominator
    kernel on each of ``n`` contiguous kv shards, combined by
    ``parallel.sp.combine_shard`` / ``combine_result`` (q prescaled)."""
    from ..parallel.sp import combine_result, combine_shard

    acc = den = None
    for ks, vs in zip(k.chunk(n, dim=2), v.chunk(n, dim=2)):
        acc, den = combine_shard(acc, den, *flash_attention_denom(q, ks.contiguous(), vs.contiguous(), scale=1.0))
    return combine_result(acc, den, q.dtype)


def ring_case(b, h, s, d=128, *, seed=0, device="cuda"):
    """flash_case's q, k, v with v at an eighth of its scale, so |o| < 0.5:
    JAX's absolute bound presumes outputs below 1 (its test's are ~0.01).
    Each shard's o_i is rounded to bf16 before the combine, and the result
    again: a bf16 step is 2^-9 below 0.5 but 2^-6 at flash_case's |o| of up
    to ~4, where the peaky logits make o nearly one row of v."""
    q, k, v = flash_case(b, h, s, s, d, seed=seed, device=device)
    return q, k, (v.float() * 0.125).to(torch.bfloat16)


def check_ring_shards(q, k, v, n):
    """:func:`ring_shards` against the dense one-tile kernel: within 5e-3
    absolute (JAX's bound, tests/test_parallel.py) and 1e-2 of its max
    |value| (the flash checks' bound)."""
    b, h, sq, d = q.shape
    out = ring_shards(q, k, v, n).transpose(1, 2).reshape(b, sq, h * d)
    err, rel = _rel(out, flash_attention(q, k, v))
    ok = err <= 5e-3 and rel <= 1e-2 and bool(torch.isfinite(out.float()).all())
    return err, ok, (f"{n} kv shards combined vs dense: max abs {err:.3e} (tol 5e-3), rel {rel:.2e} "
                     f"(tol 1e-2)")


def check_flash_unroll2(q, k, v):
    """Prescaled q, (B, S, H*D) out, as FLUX calls it: max error <= 1e-2 of
    the plain twin's max |value|."""
    out = flash_attention_unroll2(q, k, v, scale=1.0, out_bshd=True)
    ref = flash_attention_unroll2_plain(q, k, v, 1.0, out_bshd=True)
    err, rel = _rel(out, ref)
    ok = rel <= 1e-2 and out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2)"


def flash_i8_case(b, h, sq, skv, d=128, *, seed=0, device="cuda"):
    """flash_case's prescaled q, k, v through quantize_qk -> (q8, qs, k8,
    ks, v)."""
    q, k, v = flash_case(b, h, sq, skv, d, seed=seed, device=device)
    q8, qs, k8, ks = quantize_qk(q, k)
    return q8, qs, k8, ks, v


def check_flash_i8(q8, qs, k8, ks, v, out_bshd=True):
    """(B, S, H*D) out as FLUX calls it, or (B, H, S, D): max error <= 1e-2
    of the plain twin's max |value| (the twin's int8 products are exact in
    f32)."""
    out = flash_attention_i8(q8, qs, k8, ks, v, out_bshd=out_bshd)
    ref = flash_attention_i8_plain(q8, qs, k8, ks, v, out_bshd=out_bshd)
    err, rel = _rel(out, ref)
    ok = rel <= 1e-2 and out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2)"


def check_flash_online(q, k, v, out_bshd=False):
    """bf16 output, (B, H, Sq, D) or (B, Sq, H*D), softmax scale 1/sqrt(D):
    max error <= 1e-2 of the plain output's max |value| (the twin runs the
    kernel's kv steps: 128 columns up to head dim 128, 64 above, and above
    it the kernel's kv splits, merged in the same order)."""
    out = flash_attention_online(q, k, v, out_bshd=out_bshd)
    ref = flash_attention_online_plain(q, k, v, out_bshd=out_bshd)
    err, rel = _rel(out, ref)
    ok = rel <= 1e-2 and out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2)"


def check_ln_mod_quant(x, sc, sh, smooth, pd):
    """Codes: at most one code apart, on at most 0.1% of elements (the
    LayerNorm sums run in another order); scales: relative error <= 1e-5;
    lora_act: max error <= 1e-2 of its max |value|."""
    q, s, la = ln_mod_quant_int8(x, sc, sh, smooth, pd)
    qr, sr, lr = ln_mod_quant_int8_plain(x, sc, sh, smooth, pd)
    diff = (q.int() - qr.int()).abs()
    code_max = diff.max().item()
    frac = (diff > 0).float().mean().item()
    s_rel = ((s - sr).abs() / sr.abs().clamp_min(1e-30)).max().item()
    _, l_rel = _rel(la, lr)
    ok = (code_max <= 1 and frac <= 1e-3 and s_rel <= 1e-5 and l_rel <= 1e-2
          and q.shape == qr.shape and s.shape == sr.shape and la.shape == lr.shape)
    detail = (f"max code diff {code_max} on {frac:.2e} of codes (tol 1 on <=1e-3); "
              f"scale rel {s_rel:.2e} (tol 1e-5); lora_act rel {l_rel:.2e} (tol 1e-2)")
    return float(code_max), ok, detail


def run_qkv_rope(fn, streams, cos, sin, q_scale=LOG2E / math.sqrt(128)):
    """Every stream through ``fn`` into one joint buffer set."""
    b, _, n3 = streams[0][0].shape
    d = streams[0][1].shape[0]
    s_all = cos.shape[0]
    out = tuple(torch.empty((b, n3 // 3 // d, s_all, d), dtype=torch.bfloat16, device=cos.device)
                for _ in range(3))
    for qkv, nq, nk, la, pu, off in streams:
        s = qkv.shape[1]
        fn(qkv, cos[off:off + s], sin[off:off + s], nq, nk, q_scale=q_scale, lora_act=la, proj_up=pu,
           out=out, s_offset=off)
    return out


def check_qkv_rope(streams, cos, sin):
    """q, k, v (bf16): max error <= 1e-2 of the plain output's max |value|."""
    out = run_qkv_rope(qkv_rope_producer, streams, cos, sin)
    ref = run_qkv_rope(qkv_rope_producer_plain, streams, cos, sin)
    errs = [_rel(o, r) for o, r in zip(out, ref)]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    ok = rel <= 1e-2 and all(bool(torch.isfinite(o.float()).all()) for o in out)
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} over q, k, v (tol 1e-2)"


def check_ptoken(qa, ascales, w, wscales, la, pu, bias, rsm, pd, act_unsigned_next=False):
    """The per-token producer (qscales (1, M)) against its plain twin:
    scales within 1e-6 relative; codes equal but for flips at a rounding
    boundary: every differing code one apart, where the twin's h * rcp(scale)
    lies within 1e-3 of a .5 boundary (the kernel's f32 epilogue, its tanhf
    and its low-rank sum order against the twin's torch ops move h by a few
    ulp, so only a code at a tie can flip), counted in the detail, on at
    most 0.1% of codes; lora_next within 1e-2 of its max |value|."""
    kw = dict(act_unsigned_next=act_unsigned_next, ptoken=True)
    q, s, l = svdq_gemm_w8a8_gelu_quant(qa, ascales, w, wscales, la, pu, bias, rsm, pd, **kw)
    qr, sr, lr = svdq_gemm_w8a8_gelu_quant_plain(qa, ascales, w, wscales, la, pu, bias, rsm, pd, **kw)
    h, _ = chain_h_plain(qa, ascales, w, wscales, la, pu, bias, rsm, pd, act_unsigned_next)
    t = h * rcp(sr).reshape(-1, 1)
    at_tie = ((t - t.floor()) - 0.5).abs() <= 1e-3
    diff = (q.int() - qr.int()).abs()
    flips = int((diff > 0).sum().item())
    off_tie = int(((diff > 0) & ~at_tie).sum().item())
    s_rel = ((s - sr).abs() / sr.abs().clamp_min(1e-30)).max().item()
    _, l_rel = _rel(l, lr)
    ok = (diff.max().item() <= 1 and off_tie == 0 and flips <= 1e-3 * q.numel() and s_rel <= 1e-6
          and l_rel <= 1e-2 and q.shape == qr.shape and s.shape == sr.shape == (1, qa.shape[0]))
    detail = (f"{flips} of {q.numel()} codes flipped (one apart, {off_tie} off a .5 tie; tol 0 off a tie, "
              f"<=1e-3 in all); scale rel {s_rel:.2e} (tol 1e-6); lora_next rel {l_rel:.2e} (tol 1e-2)")
    return float(diff.max().item()), ok, detail


def check_rank1(qa, ascales, w, wscales, la, pu, bias, residual=None):
    """The consumer's rank-1 mode (ascales (1, M)) against its plain twin:
    every element within one bf16 step (|err| <= 2^-7 |ref| + 1e-4 max
    |ref|): both scale the same exact int32 sum, only the low-rank term's f32
    sum runs in another order; with the residual epilogue 1e-2 of max |ref|
    (the GEMM output is rounded to bf16 before the gated add)."""
    out = gemm_w8a8_rank1(qa, ascales, w, wscales, la, pu, bias, residual)
    ref = gemm_w8a8_grouped_plain(qa, ascales, w, wscales, la, pu, bias, residual)
    err, rel = _rel(out, ref)
    o, r = out.float(), ref.float()
    beyond = ((o - r).abs() > 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()).sum().item()
    ok = (rel <= 1e-2 if residual is not None else beyond == 0) and out.shape == ref.shape
    return err, ok and bool(torch.isfinite(o).all()), (
        f"max abs {err:.3e}, rel {rel:.2e}; {beyond} elements beyond one bf16 step "
        f"(tol {'rel 1e-2' if residual is not None else '0'})")


def check_stacked(run, weight, check):
    """A stacked mode: ``run(stack, idx)`` on every layer of a
    :func:`stack_case` stack of ``weight`` bit for bit ``run(stack[l], None)``,
    the non-stacked kernel on that layer (the same code, only the weight
    pointer moved); and ``check()``, the non-stacked kernel against its twin
    on the case's weight (the stack's last layer)."""
    stack, ids = stack_case(weight)
    same = []
    for l, i in enumerate(ids):
        a, b = run(stack, i), run(stack[l], None)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        same.append(all(torch.equal(x, y) for x, y in zip(a, b)))
    return _stacked_report(same, *check())


# the stacked chain modes (their ops.gemm.COUNTS names) that FLUX / Qwen-Image's stacks reach
STACKED_CHAIN_MODES = ("gemm_w8a8_gelu_quant_stacked", "gemm_w8a8_gelu_quant_ptoken_stacked",
                       "gemm_w8a8_grouped_stacked", "gemm_w8a8_grouped_res_stacked", "gemm_w8a8_rank1_stacked",
                       "gemm_w8a8_rank1_res_stacked", "gemm_w4a8_gelu_quant_stacked", "gemm_w4a8_grouped_stacked")


def chain_stacked_case(mode, m, k, n, r=32, *, seed=0, device="cuda"):
    """-> (run(weight, layer_idx), the case's weight, check(), the case's
    operands) of the stacked chain mode ``mode`` (one of
    :data:`STACKED_CHAIN_MODES`) at (M, K, N): the producers' operands of
    :func:`gelu_quant_case` / :func:`w4a8_gelu_quant_case`, the consumers'
    of :func:`grouped_case` / :func:`grouped_res_case` /
    :func:`w4a8_grouped_case` with the producer's K / bn scale groups (one
    for the rank-1 modes). ``check()`` holds the non-stacked kernel to its
    twin; :func:`check_stacked` adds the layer-by-layer equality."""
    producer = "gelu_quant" in mode
    ptoken = "ptoken" in mode
    groups = 1 if "rank1" in mode else k // chain_tile_n(k)
    if mode == "gemm_w4a8_gelu_quant_stacked":
        args = w4a8_gelu_quant_case(m, k, n, r, seed=seed, device=device)
        qa, asc, qw, rs, *rest = args
        return (lambda w, i: svdq_gemm_w4a8_gelu_quant(qa, asc, w, rs, *rest, layer_idx=i), qw,
                lambda: check_w4a8_gelu_quant(*args), args)
    if mode == "gemm_w4a8_grouped_stacked":
        args = w4a8_grouped_case(m, k, n, groups, r, seed=seed, device=device)
        qa, asc, qw, *rest = args
        return (lambda w, i: gemm_w4a8_grouped(qa, asc, w, *rest, layer_idx=i), qw, lambda: check_w4a8(*args), args)
    if producer:
        args = gelu_quant_case(m, k, n, r, seed=seed, device=device)
        qa, asc, w8, *rest = args
        check = (lambda: check_ptoken(*args)) if ptoken else (lambda: check_gelu_quant(*args))
        return (lambda w, i: svdq_gemm_w8a8_gelu_quant(qa, asc, w, *rest, layer_idx=i, ptoken=ptoken), w8, check,
                args)
    res = "_res" in mode
    args = (grouped_res_case(m, k, n, groups, r, seed=seed, device=device) if res
            else grouped_case(m, k, n, groups, r, seed=seed, device=device) + (None,))
    qa, asc, w8, *rest = args
    if "rank1" in mode:
        return lambda w, i: gemm_w8a8_rank1(qa, asc, w, *rest, layer_idx=i), w8, lambda: check_rank1(*args), args
    check = (lambda: check_grouped_res(*args)) if res else (lambda: check_grouped(*args[:-1]))
    return lambda w, i: gemm_w8a8_grouped(qa, asc, w, *rest, layer_idx=i), w8, check, args


def check_grouped_res(qa, ascales, w, wscales, la, pu, bias, residual):
    """bf16 output: max error <= 1e-2 of the plain output's max |value|."""
    out = gemm_w8a8_grouped_res(qa, ascales, w, wscales, la, pu, bias, residual)
    ref = gemm_w8a8_grouped_plain(qa, ascales, w, wscales, la, pu, bias, residual)
    err, rel = _rel(out, ref)
    return err, rel <= 1e-2 and out.shape == ref.shape, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2)"


MOD_DAMP = 0.125  # AdaLN modulation damping of small 4-bit models compared across devices


def damp_modulation(model) -> None:
    """Scale the AWQ modulation linears' scales and zeros (so their outputs)
    by :data:`MOD_DAMP` in place. ``random_init``'s AdaLN gates and scales reach
    ~4; a 4-bit activation code is a seventh of its group's range, so an
    input one bf16 step apart can flip codes, and such gates multiply the
    flips into the next block (the JAX package's two int4 GEMM routes, sums
    in another order only, end beyond 2e-2 apart on a 1 + 1-block model:
    tests/test_torch_int4_flux.py). A small model compared across two
    devices damps them to at most ~0.5, as a trained model's gates are
    small; :func:`check_modulation` checks the modulation linears alone."""
    for mod in _awq_linears(model):
        mod.wscales.copy_((mod.wscales.float() * MOD_DAMP).to(torch.bfloat16))
        mod.wzeros.copy_((mod.wzeros.float() * MOD_DAMP).to(torch.bfloat16))


ZIMAGE_ADALN_DAMP = 0.25  # adaLN damping of small Z-Image models compared across devices


def damp_zimage_modulation(model, scale: float = ZIMAGE_ADALN_DAMP) -> None:
    """Scale the adaLN modulation weights of a Z-Image model's modulated
    stacks (and its final layer's) in place: the random gates at
    ``random_init``'s scale multiply one 4-bit code flip into the next block
    (the JAX package's own two int4 routes end 0.127 apart on the tiny model
    of tests/test_torch_zimage.py, 3e-2 at a quarter of the scale, the
    setting those tests hold the port to)."""
    for lin in (model.noise_refiner.adaln, model.layers.adaln, model.adaln_out):
        lin.weight.copy_((lin.weight.float() * scale).to(lin.weight.dtype))


def _awq_linears(model):
    """The AWQ linears of ``model``, a stacked one as one module."""
    from ..models.linear import AWQW4A16Linear

    return [m for m in model.modules() if isinstance(m, AWQW4A16Linear)]


def _awq_layers(model):
    """The AWQ linears of ``model`` one layer at a time: a stacked one
    through the model's layer views."""
    layers = [m for m in _awq_linears(model) if m.qweight.dim() == 2]
    views = getattr(model, "layer_views", None)
    if views is not None:
        layers += [m for vs in views().values() for v in vs for m in _awq_linears(v)]
    return layers


def check_modulation(cpu_model, model, *, seed=0):
    """Every AWQ modulation linear of ``model`` against its counterpart in
    ``cpu_model`` (the plain twin) on one seeded (1, K) SiLU-like input:
    every output element within one bf16 rounding step (|err| <= 2^-7
    |ref| + 1e-4 max |ref|). Damping scales both sides alike, so this check
    keeps its power on a damped model."""
    pairs = list(zip(_awq_layers(cpu_model), _awq_layers(model)))
    worst, beyond = 0.0, 0
    with torch.no_grad():
        for ref_lin, lin in pairs:
            x = torch.nn.functional.silu(torch.randn((1, ref_lin.in_features), generator=_gen(seed, "cpu")) * 2.0)
            x = x.to(torch.bfloat16)
            r = ref_lin(x).float()
            o = lin(x.to(lin.qweight.device)).float().cpu()
            worst = max(worst, (o - r).abs().max().item())
            beyond += ((o - r).abs() > 2.0 ** -7 * r.abs() + 1e-4 * r.abs().max()).sum().item()
    ok = beyond == 0 and len(pairs) > 0
    return worst, ok, f"{len(pairs)} linears, max abs {worst:.3e}; {beyond} elements beyond one bf16 step (tol 0)"


def _swap_planes(m):
    q = m.qweight
    m.qweight = (((q & 0xF) << 4) | ((q >> 4) & 0xF)).to(torch.int8)


# Wrong modulation kernels, emulated by wrong weights in the modulation
# linears: what a kernel that misread its operands would compute.
MOD_MUTATIONS = {
    "nibble planes swapped": _swap_planes,
    "scale groups shifted by one": lambda m: setattr(m, "wscales", torch.roll(m.wscales, 1, -2)),
    "zeros left out": lambda m: setattr(m, "wzeros", torch.zeros_like(m.wzeros)),
    "bias left out": lambda m: setattr(m, "bias", None),
}


def mutate_modulation(model, name: str) -> None:
    """Apply :data:`MOD_MUTATIONS` ``name`` to every AWQ modulation linear
    of ``model`` in place."""
    for mod in _awq_linears(model):
        MOD_MUTATIONS[name](mod)


# ---------------------------------------------------------------------------
# the four op-level entry points no model path calls (the JAX package keeps
# them off its models too): the dual LN producer, qkv_prepare, token-major
# flash, the pipelined chain producer
# ---------------------------------------------------------------------------


def ln_dual_case(b, s, k, r1=32, r2=32, *, seed=0, device="cuda"):
    """ln_mod_quant_case's stream and modulation with two heads: (x, mod
    scale, mod shift, smooth_a, proj_down_a (K, r1), smooth_b, proj_down_b
    (K, r2)), the second head's from its own seed."""
    x, sc, sh, sma, pda = ln_mod_quant_case(b, s, k, r1, seed=seed, device=device)
    _, _, _, smb, pdb = ln_mod_quant_case(1, 1, k, r2, seed=seed + 1, device=device)
    return x, sc, sh, sma, pda, smb, pdb


def _codes_report(q, qr):
    diff = (q.int() - qr.int()).abs()
    return diff.max().item(), (diff > 0).float().mean().item()


def check_ln_dual(x, sc, sh, sma, pda, smb, pdb):
    """Each head against the twin with row 6's bounds (codes at most one
    apart on at most 0.1%, scales relative error <= 1e-5, lora_act <= 1e-2
    of its max |value|), and bit for bit a single-mode launch of the kernel
    (ln_mod_quant_int8) with that head's smooth and proj_down."""
    out = ln_mod_quant_int8_dual(x, sc, sh, sma, pda, smb, pdb)
    ref = ln_mod_quant_int8_dual_plain(x, sc, sh, sma, pda, smb, pdb)
    singles = [ln_mod_quant_int8(x, sc, sh, sm, pd) for sm, pd in ((sma, pda), (smb, pdb))]
    code_max, frac, s_rel, l_rel, same = 0.0, 0.0, 0.0, 0.0, True
    for (q, s, la), (qr, sr, lr), single in zip(out, ref, singles):
        cm, fr = _codes_report(q, qr)
        code_max, frac = max(code_max, cm), max(frac, fr)
        s_rel = max(s_rel, ((s - sr).abs() / sr.abs().clamp_min(1e-30)).max().item())
        l_rel = max(l_rel, _rel(la, lr)[1])
        same = same and all(torch.equal(a, b) for a, b in zip((q, s, la), single))
    ok = code_max <= 1 and frac <= 1e-3 and s_rel <= 1e-5 and l_rel <= 1e-2 and same
    return float(code_max), ok, (f"max code diff {code_max} on {frac:.2e} of codes (tol 1 on <=1e-3); scale rel "
                                 f"{s_rel:.2e} (tol 1e-5); lora_act rel {l_rel:.2e} (tol 1e-2); each head == a "
                                 f"single-mode launch: {same}")


def check_qkv_prepare(qkv, cos, sin, nq, nk, heads, q_scale=LOG2E / math.sqrt(128)):
    """q, k, v (bf16): max error <= 1e-2 of the twin's max |value|, and bit
    for bit the producer kernel (qkv_rope_producer) without low-rank operands."""
    kw = dict(heads=heads, head_dim=nq.shape[0], q_scale=q_scale)
    out = qkv_prepare(qkv, cos, sin, nq, nk, **kw)
    ref = qkv_prepare_plain(qkv, cos, sin, nq, nk, **kw)
    prod = qkv_rope_producer(qkv, cos, sin, nq, nk, q_scale=q_scale)
    errs = [_rel(o, r) for o, r in zip(out, ref)]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    same = all(torch.equal(o, p) for o, p in zip(out, prod))
    ok = rel <= 1e-2 and same and all(bool(torch.isfinite(o.float()).all()) for o in out)
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} over q, k, v (tol 1e-2); == the producer kernel: {same}"


def flash_bshd_case(b, h, sq, skv, d=128, *, seed=0, device="cuda"):
    """flash_online_case's q, k, v (logits of std ~4 at scale 1/sqrt(D)) in
    the token-major layout (B, S, H, D)."""
    return tuple(t.transpose(1, 2).contiguous() for t in flash_online_case(b, h, sq, skv, d, seed=seed,
                                                                           device=device))


def check_flash_bshd(q, k, v):
    """(B, S, H, D) bf16 output: max error <= 1e-2 of the twin's max |value|,
    the twin at the kernel's 128-column kv tile (row 5's bound); and bit for
    bit the online kernel on the transposed tensors, (B, S, H*D) out."""
    out = flash_attention_bshd(q, k, v)
    ref = flash_attention_bshd_plain(q, k, v, bkv=ONLINE_BKV)
    err, rel = _rel(out, ref)
    b, sq, h, d = q.shape
    dense = flash_attention_online(*(t.transpose(1, 2).contiguous() for t in (q, k, v)), out_bshd=True)
    same = torch.equal(out.reshape(b, sq, h * d), dense)
    ok = rel <= 1e-2 and same and out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    return err, ok, f"max abs {err:.3e}, rel {rel:.2e} (tol 1e-2); == the online kernel on (B, H, S, D): {same}"


def check_gelu_quant_pipe(qa, ascales, w, wscales, la, pu, bias, rsm, pd, act_unsigned_next=False):
    """The pipelined producer (pipelined=True; K must be its own K tile):
    qout, qscales and lora_next bit for bit the ordinary producer kernel's
    (row 2), and through it against the twin on row 2's bounds
    (:func:`check_gelu_quant`)."""
    kw = dict(act_unsigned_next=act_unsigned_next)
    args = (qa, ascales, w, wscales, la, pu, bias, rsm, pd)
    pipe = svdq_gemm_w8a8_gelu_quant(*args, pipelined=True, **kw)
    plain_kernel = svdq_gemm_w8a8_gelu_quant(*args, **kw)
    same = [torch.equal(a, b) for a, b in zip(pipe, plain_kernel)]
    ref = svdq_gemm_w8a8_gelu_quant_plain(*args, **kw)
    code_max, frac = _codes_report(pipe[0], ref[0])
    s_rel = ((pipe[1] - ref[1]).abs() / ref[1].abs().clamp_min(1e-30)).max().item()
    _, l_rel = _rel(pipe[2], ref[2])
    ok = all(same) and code_max <= 1 and frac <= 1e-3 and s_rel <= 1e-5 and l_rel <= 1e-2
    return float(code_max), ok, (f"== the ordinary producer kernel (qout, qscales, lora_next): {same}; vs twin: "
                                 f"max code diff {code_max} on {frac:.2e} (tol 1 on <=1e-3), scale rel {s_rel:.2e} "
                                 f"(tol 1e-5), lora_next rel {l_rel:.2e} (tol 1e-2)")


# ---------------------------------------------------------------------------
# the GEMM probes (ops/gemm_probe.py; the ported tools, no model path)
# ---------------------------------------------------------------------------


def probe_i8_case(m, k, n, *, seed=0, device="cuda"):
    """int8 a (M, K) and w (K, N) over [-127, 127) (the probe scripts'
    draws), w K-contiguous as the tools hold it; rank-1 scales (M,) and (N,)
    f32 in [0, 1) (bench_gemm_variants' at / wt)."""
    g = _gen(seed, device)
    a = torch.randint(-127, 127, (m, k), dtype=torch.int8, device=device, generator=g)
    w = torch.randint(-127, 127, (n, k), dtype=torch.int8, device=device, generator=g).t()
    return a, w, torch.rand((m,), device=device, generator=g), torch.rand((n,), device=device, generator=g)


def check_probe_i8(a, w, a_scale=None, w_scale=None, *, acc="i32", tile="chain"):
    """The int8 probe kernel bit for bit its plain version at the tile's K
    depth (exact int32 products; the same f32 operations in the same order)."""
    out = gemm_probe_i8(a, w, a_scale, w_scale, acc=acc, tile=tile)
    ref = gemm_probe_i8_plain(a, w, a_scale, w_scale, acc=acc, bk=I8_TILES[tile][3])
    err = (out.float() - ref.float()).abs().max().item()
    same = torch.equal(out, ref)
    ok = same and bool(torch.isfinite(out.float()).all())
    return err, ok, f"bit for bit the plain version: {same} (max abs {err:.3e})"


def probe_bf16_case(m, k, n, a_form, w_form, scaled, *, seed=0, device="cuda"):
    """Operands in their stored forms (bench_gemm_variants' draws): bf16
    normal, int8 codes in [-7, 7], packed int4 bytes over [-127, 127]; with
    ``scaled``, group-64 scales (K/64, M) and (K/64, N) bf16 in [0, 1)."""
    g = _gen(seed, device)

    def operand(form, shape, packed_dim):
        if form == "bf16":
            return torch.randn(shape, device=device, generator=g).to(torch.bfloat16)
        if form == "i8":
            return torch.randint(-7, 8, shape, dtype=torch.int8, device=device, generator=g)
        shape = tuple(s // 2 if i == packed_dim else s for i, s in enumerate(shape))
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=device, generator=g)

    a, w = operand(a_form, (m, k), 1), operand(w_form, (k, n), 0)
    if not scaled:
        return a, w, None, None
    return (a, w, torch.rand((k // 64, m), device=device, generator=g).to(torch.bfloat16),
            torch.rand((k // 64, n), device=device, generator=g).to(torch.bfloat16))


# the limit on bf16_order_factor: about twice the largest read on the H100 (0.070 over the six forms at three probe
# shapes and two seeds, chip_smoke.py's probe rows; 0.003 on the CPU against the JAX bodies, the CPU tests); a
# product summed in bf16 reads 300 and more
BF16_ORDER_C = 0.15


def bf16_order_factor(out, ref, a_dec, w_dec) -> float:
    """The least c with |out - ref| <= step + c sqrt(K) 2^-24 sum_k |a_k w_k|
    at every element, where step is one bf16 step at the larger of |out|
    and |ref|: how far apart the f32 sums' two orders put the outputs, in
    units of the size of the rounding of a sum of K terms (sqrt(K) roundings
    of 2^-24 of sum_k |a_k w_k| at most). The term keeps a sum that cancels
    to near 0 from being held to a step of its tiny value."""
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    unit = math.sqrt(a_dec.shape[1]) * 2.0 ** -24 * (a_dec.float().abs() @ w_dec.float().abs())
    return ((o - r).abs() - step).clamp_min(0).div(unit.clamp_min(1e-30)).max().item()


def bf16_accumulated(a_dec, w_dec, bk=64):
    """The control a limit on the order must reject: the decoded product
    with its accumulator held in bf16, one f32 K-tile partial added at a
    time (what a kernel that sums in bf16 computes)."""
    acc = torch.zeros((a_dec.shape[0], w_dec.shape[1]), dtype=torch.bfloat16, device=a_dec.device)
    for k0 in range(0, a_dec.shape[1], bk):
        acc = (acc.float() + a_dec[:, k0:k0 + bk].float() @ w_dec[k0:k0 + bk].float()).to(torch.bfloat16)
    return acc


def check_probe_bf16(a, w, a_scale=None, w_scale=None, *, a_form="bf16", w_form="bf16"):
    """The bf16-operand probe kernel against its plain version: within one
    bf16 step elementwise up to the f32 sums' order, c <= BF16_ORDER_C
    (:func:`bf16_order_factor`); the same limit rejects the plain product
    summed in bf16 (:func:`bf16_accumulated`), or the check fails."""
    kw = dict(a_form=a_form, w_form=w_form)
    out = gemm_probe_bf16(a, w, a_scale, w_scale, **kw)
    ref = gemm_probe_bf16_plain(a, w, a_scale, w_scale, **kw)
    a_dec, w_dec = decode_operand(a, a_form, a_scale, dim=1), decode_operand(w, w_form, w_scale, dim=0)
    c = bf16_order_factor(out, ref, a_dec, w_dec)
    control = bf16_order_factor(bf16_accumulated(a_dec, w_dec), ref, a_dec, w_dec)
    err = (out.float() - ref.float()).abs().max().item()
    ok = c <= BF16_ORDER_C < control and bool(torch.isfinite(out.float()).all())
    return err, ok, (f"max abs {err:.3e}; order factor c {c:.4g} (tol {BF16_ORDER_C}; summed in bf16 the plain "
                     f"product reads {control:.4g})")

# ---------------------------------------------------------------------------
# the producers at ranks above 32
# ---------------------------------------------------------------------------


def check_ln_rank(x, sc, sh, smooth, pd, r_small=32):
    """The LN producer at rank R = ``pd``'s width: within row 6's bounds of
    the twin (:func:`check_ln_mod_quant`), and bit for bit a launch with
    ``pd``'s first ``r_small`` columns in the codes, the scales and those
    lora_act columns (each lora_act element is the same sum in the same
    order at any rank)."""
    err, ok, detail = check_ln_mod_quant(x, sc, sh, smooth, pd)
    q, s, la = ln_mod_quant_int8(x, sc, sh, smooth, pd)
    q2, s2, la2 = ln_mod_quant_int8(x, sc, sh, smooth, pd[:, :r_small].contiguous())
    same = torch.equal(q, q2) and torch.equal(s, s2) and torch.equal(la[:, :r_small], la2)
    return err, ok and same, f"{detail}; == the rank-{r_small} launch on its columns: {same}"


def check_qkv_rank(streams, cos, sin, r_small=32):
    """The qkv producer at the streams' rank R: within row 7's bound of the
    twin (:func:`check_qkv_rope`), and the low-rank operands cut to their
    first ``r_small`` columns / rows give, zero-padded back to R, the
    outputs of the rank-``r_small`` launch bit for bit (the padded steps add
    exact zeros)."""
    err, ok, detail = check_qkv_rope(streams, cos, sin)
    pad = torch.nn.functional.pad
    cut = [(qkv, nq, nk, la[..., :r_small].contiguous(), pu[:r_small].contiguous(), off)
           for qkv, nq, nk, la, pu, off in streams]
    r = streams[0][3].shape[-1]
    padded = [(qkv, nq, nk, pad(la, (0, r - r_small)), pad(pu, (0, 0, 0, r - r_small)), off)
              for qkv, nq, nk, la, pu, off in cut]
    same = all(torch.equal(a, b) for a, b in zip(run_qkv_rope(qkv_rope_producer, cut, cos, sin),
                                                 run_qkv_rope(qkv_rope_producer, padded, cos, sin)))
    return err, ok and same, f"{detail}; rank {r_small} zero-padded to {r} == rank {r_small}: {same}"


# ---------------------------------------------------------------------------
# ranks above 128: every low-rank kernel runs its ranks in chunks of 128
# ---------------------------------------------------------------------------

# the kernels whose rank term runs in chunks of 128 ranks (check_chunk_boundary's kinds)
CHUNK_KINDS = ("gelu_quant", "gelu_quant_pipe", "w4a8_gelu_quant", "grouped", "grouped_res", "w4a8",
               "w4a8_grouped", "ln", "ln_dual")


def _rank_pad(t: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` (-1 columns, 0 rows) to ``r``."""
    pad = r - t.shape[dim]
    return torch.nn.functional.pad(t, (0, pad) if dim == -1 else (0, 0, 0, pad)).contiguous()


def chunk_case(kind, m, k, n, r=128, *, groups=2, seed=0, device="cuda"):
    """-> run(r_pad): the launch of ``kind`` (one of :data:`CHUNK_KINDS`) at
    (M, K, N) and rank ``r`` with its low-rank operands zero-padded to
    ``r_pad`` ranks (r_pad = r: the operands as drawn), returning its
    outputs as a tuple. The producers pad lora_act, proj_up and
    proj_down_next; the consumers lora_act, proj_up and the residual's
    extra_la / extra_pu; the LN producers proj_down (K = ``k``, M = ``m``
    tokens)."""
    if kind in ("ln", "ln_dual"):
        if kind == "ln":
            x, sc, sh, sm, pd = ln_mod_quant_case(1, m, k, r, seed=seed, device=device)
            return lambda rp: ln_mod_quant_int8(x, sc, sh, sm, _rank_pad(pd, rp, -1))
        x, sc, sh, sma, pda, smb, pdb = ln_dual_case(1, m, k, r, r, seed=seed, device=device)
        return lambda rp: sum(ln_mod_quant_int8_dual(x, sc, sh, sma, _rank_pad(pda, rp, -1), smb,
                                                     _rank_pad(pdb, rp, -1)), ())
    if "gelu_quant" in kind:
        if kind == "w4a8_gelu_quant":
            qa, asc, qw, rs, ws, la, pu, bias, rsm, pd = w4a8_gelu_quant_case(m, k, n, r, seed=seed, device=device)
            fn = lambda *a: svdq_gemm_w4a8_gelu_quant(qa, asc, qw, rs, ws, *a)
        else:
            qa, asc, w, ws, la, pu, bias, rsm, pd = gelu_quant_case(m, k, n, r, seed=seed, device=device)
            fn = lambda *a: svdq_gemm_w8a8_gelu_quant(qa, asc, w, ws, *a, pipelined=kind == "gelu_quant_pipe")
        return lambda rp: fn(_rank_pad(la, rp, -1), _rank_pad(pu, rp, 0), bias, rsm, _rank_pad(pd, rp, -1))
    if kind in ("w4a8", "w4a8_grouped"):
        case = w4a8_case(m, k, n, r, seed=seed, device=device) if kind == "w4a8" else w4a8_grouped_case(
            m, k, n, groups, r, seed=seed, device=device)
        qa, asc, qw, rs, ws, la, pu, bias = case
        fn = gemm_w4a8 if kind == "w4a8" else gemm_w4a8_grouped
        return lambda rp: (fn(qa, asc, qw, rs, ws, _rank_pad(la, rp, -1), _rank_pad(pu, rp, 0), bias),)
    if kind == "grouped_res":
        qa, asc, w, ws, la, pu, bias, (x, gate, ex, ela, epu) = grouped_res_case(m, k, n, groups, r, seed=seed,
                                                                                 device=device)
        return lambda rp: (gemm_w8a8_grouped(qa, asc, w, ws, _rank_pad(la, rp, -1), _rank_pad(pu, rp, 0), bias,
                                             (x, gate, ex, _rank_pad(ela, rp, -1), _rank_pad(epu, rp, 0))),)
    qa, asc, w, ws, la, pu, bias = grouped_case(m, k, n, groups, r, seed=seed, device=device)
    return lambda rp: (gemm_w8a8_grouped(qa, asc, w, ws, _rank_pad(la, rp, -1), _rank_pad(pu, rp, 0), bias),)


def check_chunk_boundary(run, r=128, r_pad=256):
    """A kernel at rank ``r`` (128: exactly one chunk) against the same
    launch with its low-rank operands zero-padded to ``r_pad`` (a second
    chunk of zeros): every output bit for bit, the low-rank outputs
    (lora_next, lora_act) on their first ``r`` columns and zeros past them
    (the second chunk adds exact zeros to each sum, in the same order)."""
    base, padded = run(r), run(r_pad)
    same = True
    for a, b in zip(base, padded):
        if b.ndim == 2 and a.shape != b.shape:  # a low-rank output, r_pad columns
            same = same and torch.equal(b[:, :r], a) and not b[:, r:].any()
        else:
            same = same and torch.equal(a, b)
    return 0.0, bool(same), f"rank {r} zero-padded to {r_pad} == rank {r} (every output bit for bit): {same}"
