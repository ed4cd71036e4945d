"""Decoders and packers of the nunchaku / deepcompressor checkpoint layouts.

Port copy of ``nunchaku_tpu/utils/nunchaku_format.py`` (its twelve
functions), on torch tensors. Nunchaku checkpoints store quantized weights
pre-swizzled into CUDA MMA-fragment order (nunchaku/lora/flux/packer.py:
pack_weight :188-244, pack_scale :246-302, pack_micro_scale :304-362,
pack_lowrank_weight :364-398; int4 parameters bits=4, warp_n=128: comp_n=16,
comp_k=64, lanes 8x4, reg_k=8, n/k_pack_size=2). The ``unpack_*`` functions
invert those layouts into plain row-major tensors, the ``pack_*`` functions
rebuild them (to synthesize or export reference-format files).

Every function is reshapes, permutes and integer bit operations, so it
gives the same values on any device: the loaders decode on the device the
model is built on, the tests on the CPU. Scale tensors of any dtype pass
through unchanged (fp8 scales as their uint8 bytes, as the JAX loader
passes them).
"""

from __future__ import annotations

import torch

# MMA tiling constants for bits=4, warp_n=128 (the only config nunchaku
# ships for W4A4 blocks).
NUM_N_LANES = 8
NUM_K_LANES = 4
REG_K = 8  # int4 values per 32-bit register
N_PACK = 2
K_PACK = 2
MEM_N = 128  # warp_n
MEM_K = 64  # comp_k
NUM_N_PACKS = MEM_N // (N_PACK * NUM_N_LANES)  # 8
NUM_K_PACKS = 1


def _nibbles(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> (..., 8) nibbles 0..15, least significant first."""
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=words.device)
    return (words.unsqueeze(-1) >> shifts) & 0xF


def _words(nibbles: torch.Tensor) -> torch.Tensor:
    """(..., 8) nibbles -> int32 words (the inverse of :func:`_nibbles`)."""
    shifts = torch.arange(0, 32, 4, dtype=torch.int64, device=nibbles.device)
    w = ((nibbles.to(torch.int64) & 0xF) << shifts).sum(dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_weight_int4(packed: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Packed int8 (n, k/2) MMA-swizzled -> signed int4 values (n, k) int8."""
    w32 = packed.reshape(n, k // 2).contiguous().view(torch.int32)
    nib = _nibbles(w32.reshape(-1)).to(torch.int8)
    nib = torch.where(nib >= 8, nib - 16, nib)  # sign-extend
    # (n_tiles, k_tiles, num_k_packs, num_n_packs, num_n_lanes, num_k_lanes,
    #  n_pack_size, k_pack_size, reg_n, reg_k)
    nt, kt = n // MEM_N, k // MEM_K
    arr = nib.reshape(nt, kt, NUM_K_PACKS, NUM_N_PACKS, NUM_N_LANES, NUM_K_LANES, N_PACK, K_PACK, 1, REG_K)
    # invert permute(0, 5, 6, 1, 3, 8, 2, 7, 4, 9) of the logical view
    return arr.permute(0, 3, 6, 4, 8, 1, 2, 7, 5, 9).reshape(n, k).contiguous()


def unpack_scale(packed: torch.Tensor, n: int, warp_n: int = 128) -> torch.Tensor:
    """Packed group scales -> (num_groups, n) row-major (inverse of
    pack_scale, packer.py:246-302)."""
    s_pack_size = min(max(warp_n // 32, 2), 8)
    num_s_lanes = min(32, warp_n // s_pack_size)
    num_s_packs = warp_n // (s_pack_size * num_s_lanes)
    flat = packed.reshape(-1)
    g = flat.numel() // n
    arr = flat.reshape(n // warp_n, g, num_s_packs, num_s_lanes // 4, 4, s_pack_size // 2, 2)
    arr = arr.permute(0, 2, 3, 5, 4, 6, 1).reshape(n, g)
    return arr.t().contiguous()


def unpack_micro_scale(packed: torch.Tensor, n: int, warp_n: int = 128) -> torch.Tensor:
    """Packed fp8-e4m3 micro scales (nvfp4, group 16) -> (num_groups, n)
    (inverse of pack_micro_scale, packer.py:304-362). Pass the bytes
    (uint8); the values come back in the dtype given."""
    s_pack_size = min(max(warp_n // 32, 1), 4)
    num_s_packs = -(-warp_n // (s_pack_size * 32))
    flat = packed.reshape(-1)
    g = flat.numel() // n
    arr = flat.reshape(n // warp_n, g // 4, num_s_packs, 8, 4, s_pack_size, 4)
    arr = arr.permute(0, 2, 5, 4, 3, 1, 6).reshape(n, g)
    return arr.t().contiguous()


_PACK_N = N_PACK * NUM_N_LANES * 1  # 16 (reg_n = 1)
_PACK_K = K_PACK * NUM_K_LANES * 2  # 16 (reg_k = 2)


def unpack_lowrank_weight(packed: torch.Tensor, down: bool) -> torch.Tensor:
    """Inverse of pack_lowrank_weight (packer.py:364-398): torch-Linear
    layouts, down (R, K) from a tensor stored (K, R), up (N, R) from (N, R)."""
    inv_inner = (0, 1, 4, 2, 6, 5, 3, 7)  # inverse of permute(0,1,3,6,2,5,4,7)
    if down:
        kk, rr = packed.shape  # pack_n tiles the rank
        r_packs, c_packs = rr // _PACK_N, kk // _PACK_K
        arr = packed.reshape(c_packs, r_packs, NUM_N_LANES, NUM_K_LANES, N_PACK, K_PACK, 1, 2)
        arr = arr.permute(*inv_inner).reshape(c_packs, r_packs, _PACK_N, _PACK_K)
        return arr.permute(1, 2, 0, 3).reshape(rr, kk).contiguous()
    nn_, rr = packed.shape  # pack_n tiles N
    c_packs, r_packs = nn_ // _PACK_N, rr // _PACK_K
    arr = packed.reshape(c_packs, r_packs, NUM_N_LANES, NUM_K_LANES, N_PACK, K_PACK, 1, 2)
    arr = arr.permute(*inv_inner).reshape(c_packs, r_packs, _PACK_N, _PACK_K)
    return arr.permute(0, 2, 1, 3).reshape(nn_, rr).contiguous()


# ---------------------------------------------------------------------------
# AWQ GEMV layout (AdaLN modulation linears)
# ---------------------------------------------------------------------------


def _nib_of_y(device=None) -> torch.Tensor:
    """Logical y in [0, 32) of a 32-nibble chunk -> its nibble position:
    y = (i*4 + j)*2 + e sits at buffer (i + j*4)*2 + e, buffer b at nibble
    (b // 8) * 8 + [0, 4, 1, 5, 2, 6, 3, 7][b % 8]."""
    word_nibble = [0, 4, 1, 5, 2, 6, 3, 7]
    out = [0] * 32
    for i in range(4):
        for j in range(4):
            for e in range(2):
                b = (i + j * 4) * 2 + e
                out[(i * 4 + j) * 2 + e] = (b // 8) * 8 + word_nibble[b % 8]
    return torch.tensor(out, dtype=torch.int64, device=device)


def _awq_gemv_perm(oc: int, ic: int, device=None) -> torch.Tensor:
    """Nibble index map of the reference's GEMV_AWQ weight layout
    (src/kernels/awq/gemv_awq.cu:100-230): (oc, ic) -> the position in the
    flat nibble stream holding logical weight (row, k).

    In 4-row groups g, chunk q of 32 nibbles holds row 4g + (q // 2) % 4
    from k = (q // 8) * 64 + (q % 2) * 32, so q = 8 kb + 2 rr + half and
    perm[4g + rr, 64 kb + 32 half + y] = 4 g ic + 32 q + nib_of_y[y] (the JAX
    function's loops, as one broadcast)."""
    g = torch.arange(oc // 4, device=device).view(-1, 1, 1, 1, 1)
    rr = torch.arange(4, device=device).view(1, 4, 1, 1, 1)
    kb = torch.arange(ic // 64, device=device).view(1, 1, -1, 1, 1)
    half = torch.arange(2, device=device).view(1, 1, 1, 2, 1)
    y = _nib_of_y(device).view(1, 1, 1, 1, 32)
    perm = g * (4 * ic) + (kb * 8 + rr * 2 + half) * 32 + y
    return perm.reshape(oc, ic)


def unpack_awq_gemv(packed: torch.Tensor, oc: int, ic: int) -> torch.Tensor:
    """GEMV_AWQ qweight int32 (oc/4, ic/8*4) -> unsigned int4 values (oc, ic)
    int8: ``values = nibbles[_awq_gemv_perm(oc, ic)]``, taken as a reshape,
    a gather within each 32-nibble chunk and a permute. Dequant is
    ``w = q * wscales - (-stored_zeros)`` with wscales / wzeros stored plain
    (ic/G, oc) (src/Linear.cpp:25-39, gemv_awq.cu:156-157)."""
    nib = _nibbles(packed.contiguous().view(torch.int32).reshape(-1)).to(torch.int8)
    chunks = nib.reshape(oc // 4, ic // 64, 4, 2, 32)[..., _nib_of_y(packed.device)]  # [g, kb, rr, half, y]
    return chunks.permute(0, 2, 1, 3, 4).reshape(oc, ic).contiguous()


def pack_awq_gemv(values: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_awq_gemv`: unsigned int4 (oc, ic) -> int32 packed."""
    oc, ic = values.shape
    v = values.reshape(oc // 4, 4, ic // 64, 2, 32).permute(0, 2, 1, 3, 4)  # [g, kb, rr, half, y]
    chunks = torch.empty_like(v)
    chunks[..., _nib_of_y(values.device)] = v
    return _words(chunks.reshape(-1, 8)).reshape(oc // 4, ic // 8 * 4)


# ---------------------------------------------------------------------------
# TinyChat W4 layout (4-bit T5 encoder)
# ---------------------------------------------------------------------------


def unpack_tinychat_w4(packed: torch.Tensor, oc: int, ic: int) -> torch.Tensor:
    """TinyChat int16 qweight (oc/4, ic) -> unsigned int4 values (oc, ic) int8
    (inverse of pack_w4, nunchaku/models/text_encoders/tinychat_utils.py:76:
    per 32-k chunk, nibble j of int16 element i holds k = 8*j + i, and the
    (oc//4, 4, ic//64, 16) rows / columns are transposed)."""
    w = packed.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    w = w.reshape(oc // 4, ic // 64, 4, 16).permute(0, 2, 1, 3).reshape(oc * ic // 32, 8)
    shifts = torch.arange(0, 16, 4, dtype=torch.int32, device=w.device).view(1, 4, 1)
    return ((w.unsqueeze(1) >> shifts) & 0xF).to(torch.int8).reshape(oc, ic)


def pack_tinychat_w4(values: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_tinychat_w4`."""
    oc, ic = values.shape
    v = values.reshape(oc * ic // 32, 4, 8).to(torch.int32) & 0xF
    w = v[:, 0] | (v[:, 1] << 4) | (v[:, 2] << 8) | (v[:, 3] << 12)
    w = w.reshape(oc // 4, 4, ic // 64, 16).permute(0, 2, 1, 3).reshape(oc // 4, ic)
    return torch.where(w >= 2**15, w - 2**16, w).to(torch.int16)


# ---------------------------------------------------------------------------
# Forward packers (exporting, merging, synthesizing reference-format files)
# ---------------------------------------------------------------------------


def pack_weight_int4(values: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_weight_int4`: signed int4 (n, k) -> packed int8 (n, k/2)."""
    n, k = values.shape
    nt, kt = n // MEM_N, k // MEM_K
    arr = values.reshape(nt, NUM_N_PACKS, N_PACK, NUM_N_LANES, 1, kt, NUM_K_PACKS, K_PACK, NUM_K_LANES, REG_K)
    arr = arr.permute(0, 5, 6, 1, 3, 8, 2, 7, 4, 9)
    return _words(arr.reshape(-1, 8)).view(torch.int8).reshape(n, k // 2)


def pack_scale_ref(scales: torch.Tensor, warp_n: int = 128) -> torch.Tensor:
    """Inverse of :func:`unpack_scale`: (num_groups, n) -> reference pack order (g, n)."""
    g, n = scales.shape
    s_pack_size = min(max(warp_n // 32, 2), 8)
    num_s_lanes = min(32, warp_n // s_pack_size)
    num_s_packs = warp_n // (s_pack_size * num_s_lanes)
    arr = scales.t().reshape(n // warp_n, num_s_packs, num_s_lanes // 4, s_pack_size // 2, 4, 2, g)
    return arr.permute(0, 6, 1, 2, 4, 3, 5).reshape(g, n).contiguous()


def pack_micro_scale_ref(scales: torch.Tensor, warp_n: int = 128) -> torch.Tensor:
    """Inverse of :func:`unpack_micro_scale`: (num_groups, n) e4m3 (or its
    bytes) -> packed (g, n)."""
    g, n = scales.shape
    s_pack_size = min(max(warp_n // 32, 1), 4)
    arr = scales.t().reshape(n // warp_n, 1, s_pack_size, 4, 8, g // 4, 4)
    return arr.permute(0, 5, 1, 4, 3, 2, 6).reshape(g, n).contiguous()


def pack_lowrank_weight_ref(weight: torch.Tensor, down: bool) -> torch.Tensor:
    """Inverse of :func:`unpack_lowrank_weight` (torch-Linear layouts in)."""
    fwd_inner = (0, 1, 3, 6, 2, 5, 4, 7)
    if down:
        rr, kk = weight.shape  # (R, K)
        r_packs, c_packs = rr // _PACK_N, kk // _PACK_K
        arr = weight.reshape(r_packs, _PACK_N, c_packs, _PACK_K).permute(2, 0, 1, 3)
        arr = arr.reshape(c_packs, r_packs, N_PACK, NUM_N_LANES, 1, K_PACK, NUM_K_LANES, 2).permute(*fwd_inner)
        return arr.reshape(kk, rr).contiguous()  # stored (K, R)
    nn_, rr = weight.shape  # (N, R)
    c_packs, r_packs = nn_ // _PACK_N, rr // _PACK_K
    arr = weight.reshape(c_packs, _PACK_N, r_packs, _PACK_K).permute(0, 2, 1, 3)
    arr = arr.reshape(c_packs, r_packs, N_PACK, NUM_N_LANES, 1, K_PACK, NUM_K_LANES, 2).permute(*fwd_inner)
    return arr.reshape(nn_, rr).contiguous()  # stored (N, R)
