"""Sequence (context) parallelism: exact ring attention over a
``torch.distributed`` process group.

Counterpart of ``nunchaku_tpu/parallel/sp.py``: the token sequence is split
into contiguous blocks, one per rank in rank order (JAX's ``P(..., "sp")``),
the weights are replicated, and every per-token operation (LayerNorm, AdaLN,
the GEMMs, the residual adds) runs on the local tokens alone. Only attention
communicates: each rank attends its local queries to every kv shard as the
shards pass around the ring, rank r sending its current k and v to rank
(r + 1) % n (JAX's ``perm``) through ``dist.batch_isend_irecv``.

The fixed-shift softmax (``ops.attention.FIXED_SHIFT``) makes the combine
exact with no running max: the partial outputs over disjoint kv shards
satisfy

    o = sum_i (o_i * l_i) / sum_i l_i,     l_i = sum_k 2^(min(s_k, 116) - 16)

because every shard's p shares one global shift. Each ring step is the
denominator form of the fixed-shift kernel (``flash_attention_denom``,
count ``flash_fixed_denom``), on one rank too (n = 1 runs one step, as in
JAX). The transfer is not overlapped with the step's compute.

The forwards of :func:`parallelize_sequence`, :func:`parallelize_sequence_qwenimage`
and :func:`parallelize_sequence_zimage` take the JAX argument lists with
global tensors on every rank (what JAX's ``in_specs`` give): each rank keeps
its block of ``hidden_states`` and ``encoder_hidden_states`` (dim 1) and of
``img_ids`` / ``txt_ids`` (dim 0), runs the model on it, and all-gathers the
output along dim 1. A sequence the group's size does not divide raises. The
fused qkv prologue of FLUX and Qwen-Image stays off under SP, as in JAX
(``models/attention.py:424-431``): a model after ``enable_fused_qkv_prep()``
then raises on its half-split rope table. Qwen-Image's default ``txt_ids``
number the local tokens from 0, so a caller passes the global ids, as the
JAX test does (``tests/test_parallel.py:326-328``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.attention import flash_attention_denom


def _group(group):
    return dist.group.WORLD if group is None else group


def combine_shard(acc, den, o_i, l_i):
    """One shard's partial result into the running sums: ``acc += o_i *
    l_i``, ``den += l_i`` (f32; ``acc`` / ``den`` None start them) -> (acc,
    den)."""
    part = o_i.float() * l_i[..., None]
    if acc is None:
        return part, l_i.clone()
    return acc + part, den + l_i


def combine_result(acc, den, dtype):
    """The exact attention output from the sums: ``acc / den`` in ``dtype``."""
    return (acc / den[..., None]).to(dtype)


def _rotate(tensors, group):
    """Each of ``tensors`` to the next rank of the ring, the previous rank's
    in return (JAX's ``ppermute`` with ``perm = [(i, (i + 1) % n)]``)."""
    g = _group(group)
    n, r = dist.get_world_size(g), dist.get_rank(g)
    dst, src = dist.get_global_rank(g, (r + 1) % n), dist.get_global_rank(g, (r - 1) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, g) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, src, g) for t in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def ring_attention(q, k, v, group=None, *, scale=None):
    """Exact attention over a sequence sharded across ``group`` (None: the
    default group): q, k, v (B, H, S_local, D) bf16, this rank's block ->
    (B, H, S_local, D). Each of the n steps runs the denominator kernel on
    the current kv shard and adds its (o_i, l_i) to the sums
    (:func:`combine_shard`); k and v then move one rank along the ring.
    ``scale``: None means 1/sqrt(D), 1.0 that q carries scale * log2(e)."""
    n = dist.get_world_size(_group(group))
    acc = den = None
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for step in range(n):
        o_i, l_i = flash_attention_denom(q, k_cur, v_cur, scale=scale)
        acc, den = combine_shard(acc, den, o_i, l_i)
        if step + 1 < n:
            k_cur, v_cur = _rotate((k_cur, v_cur), group)
    return combine_result(acc, den, q.dtype)


def _set_sp_axis(model, group, module: str) -> None:
    """The ring's group on the attention module of every stack (the layer
    views hold copies: ``set_on_stacks`` rebuilds them)."""
    model.set_on_stacks(module, sp_axis=_group(group))


def _sharded_forward(group, dims):
    """forward(m, *args): each arg with a dim in ``dims`` cut to this rank's
    contiguous block along it, the model run, its output gathered along
    dim 1."""
    def shard(a, dim, n, r):
        if dim is None or a is None:
            return a
        size = a.shape[dim]
        if size % n:
            raise ValueError(f"a sequence of {size} does not split into {n} equal shards")
        return a.narrow(dim, r * (size // n), size // n)

    def forward(m, *args):
        g = _group(group)
        n, r = dist.get_world_size(g), dist.get_rank(g)
        if len(args) > len(dims):
            raise TypeError(f"the forward takes at most {len(dims)} arguments, got {len(args)}")
        out = m(*(shard(a, dim, n, r) for a, dim in zip(args, dims))).contiguous()
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out, group=g)
        return torch.cat(parts, dim=1)

    return forward


def parallelize_sequence(model, group=None):
    """Sequence-parallel FLUX forward over ``group`` (JAX :87): -> (model,
    forward), ``forward(m, hidden_states, encoder_hidden_states,
    pooled_projections, timestep, img_ids, txt_ids[, guidance])`` with
    global tensors, returning the global (B, S_img, C) output. S_img and
    S_txt must divide by the group's size."""
    _set_sp_axis(model, group, "attn")
    return model, _sharded_forward(group, (1, 1, None, None, 0, 0, None))


def parallelize_sequence_qwenimage(model, group=None):
    """Sequence-parallel Qwen-Image forward (JAX :136): ``forward(m,
    hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids)``;
    pass explicit global ``txt_ids`` (the model's default numbers each
    local shard from 0)."""
    _set_sp_axis(model, group, "attn")
    return model, _sharded_forward(group, (1, 1, None, 0, 0))


def parallelize_sequence_zimage(model, group=None):
    """Sequence-parallel Z-Image forward (JAX :177): the noise refiner, the
    context refiner and the joint layers each run the ring over their own
    local tokens; ``forward(m, hidden_states, encoder_hidden_states,
    timestep, img_ids, txt_ids)``."""
    _set_sp_axis(model, group, "attention")
    return model, _sharded_forward(group, (1, 1, None, 0, 0))
