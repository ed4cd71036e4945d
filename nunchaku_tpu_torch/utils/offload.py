"""Block offloading: a model's stacked blocks live in host memory and stream
to the card one block ahead of the compute.

Counterpart of ``nunchaku_tpu/utils/offload.py`` (``BlockStreamer`` :34,
``OffloadedFluxForward`` :63, ``OffloadedCachedFluxForward`` :106,
``OffloadedCachedQwenImageForward`` :196, ``OffloadedQwenImageForward``
:280), itself the reference's offload machinery (C++ ``LayerOffloadHelper``,
src/Module.h:214-323: a compute stream and a load stream in ping-pong; the
Python ``CPUOffloadManager``, nunchaku/models/utils.py:52-263). The card
holds the embeddings, the head, the resident blocks of the cached forms and
``lookahead + 1`` streamed blocks' weights; each streamed block runs as a
module of its own on the non-stacked modes of the kernels (as JAX's sliced
blocks do), its weights views into one flat buffer.

On the card (:class:`BlockStreamer`): each layer's buffers are packed once
into one flat pinned host buffer; ``lookahead + 1`` flat device slots are
allocated on the compute stream when a run starts and freed when it ends;
block i is copied into slot ``i % (lookahead + 1)`` on a copy stream of its
own (``non_blocking``), after the compute that last read that slot (an
event), and the compute stream waits for the copy's event before it runs the
block. No tensor is allocated on the copy stream, so the caching allocator
never hands a slot's memory to another stream while kernels read it. A
failed pinning raises. On the CPU (``device="cpu"``, the tests) the same
slots are filled by plain copies: no stream, no pinning.

The constructors copy the blocks to the host and take them from the model:
its stacks become skeletons (their structure and settings, no tensor) and its
layer views are dropped, so its device stacks are freed unless something
else holds them (a LoRA'd model shares its base's 4-bit stacks, for one).
The model keeps its embeddings and head and runs through the offloaded
forward from then on.
"""

from __future__ import annotations

import torch
from torch import nn

from ..caching.fbcache import _similar
from ..models.linear import fork_module, slice_module

ALIGN = 256  # byte alignment of each buffer in a flat block (TMA wants 16; cache lines 128)


def _skeleton(stacked: nn.Module) -> nn.Module:
    """``stacked``'s structure and settings without a tensor."""
    out = fork_module(stacked)
    for _, mod in out.named_modules():
        mod._buffers = dict.fromkeys(mod._buffers)
    return out


def _own_copy(block: nn.Module) -> nn.Module:
    """A layer view made a module of its own: each buffer copied into new
    storage of its layout, so the stack it viewed can be freed."""
    out = fork_module(block)
    for _, mod in out.named_modules():
        mod._buffers = {k: None if t is None else torch.empty_like(t).copy_(t) for k, t in mod._buffers.items()}
    return out


def _release_stacks(model: nn.Module) -> nn.Module:
    """``model`` with skeletons in place of its stacks (the attention
    settings stay readable) and no layer views, which hold views into the
    stacks: its device stacks are freed once nothing else holds them."""
    for name in model.STACKS:
        model._modules[name] = _skeleton(getattr(model, name))
    model._views = None
    return model


class BlockStreamer:
    """Streams a stacked module's layers from host memory, block by block,
    ``lookahead`` blocks ahead of the compute (JAX ``BlockStreamer``)."""

    def __init__(self, stacked_module: nn.Module, n_layers: int, device=None, lookahead: int = 1):
        first = next(stacked_module.buffers())
        self.n = n_layers
        self.lookahead = max(1, lookahead)  # read at each run
        self.device = torch.device(device) if device is not None else first.device
        self.template = _skeleton(stacked_module)
        # each buffer's place in a flat block: (name, shape, stride, dtype, byte offset)
        self.layout, offset = [], 0
        for name, t in slice_module(stacked_module, 0).named_buffers():
            stride = torch.empty_like(t, device="meta").stride()  # t's layout, packed densely
            self.layout.append((name, tuple(t.shape), stride, t.dtype, offset))
            offset += -(-t.numel() * t.element_size() // ALIGN) * ALIGN
        self.nbytes = offset
        on_card = self.device.type == "cuda"
        self.host = []
        for i in range(n_layers):
            flat = torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=on_card)
            if on_card and not flat.is_pinned():
                raise RuntimeError("pinning the host copy of a block failed")
            views = self._views(flat)
            for name, t in slice_module(stacked_module, i).named_buffers():
                views[name].copy_(t)
            self.host.append(flat)
        self.copy_stream = torch.cuda.Stream(self.device) if on_card else None

    @property
    def host_bytes(self) -> int:
        return self.nbytes * self.n

    def _views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for name, shape, stride, dtype, offset in self.layout:
            size = torch.empty((), dtype=dtype).element_size()
            n = max((s - 1) * st for s, st in zip(shape, stride)) + 1 if shape else 1
            part = flat[offset:offset + n * size].view(dtype)
            out[name] = part.as_strided(shape, stride, part.storage_offset())
        return out

    def _bind(self, flat: torch.Tensor) -> nn.Module:
        """A block module whose buffers are views into ``flat``."""
        block = fork_module(self.template)
        for name, view in self._views(flat).items():
            path, _, leaf = name.rpartition(".")
            block.get_submodule(path)._buffers[leaf] = view
        return block

    def run(self, fn, carry, *args, start: int = 0):
        """``carry = fn(block, carry, *args)`` over layers [start, n)."""
        n_slots = self.lookahead + 1
        slots = [torch.empty(self.nbytes, dtype=torch.uint8, device=self.device) for _ in range(n_slots)]
        blocks = [self._bind(s) for s in slots]
        if self.copy_stream is None:
            for i in range(start, self.n):
                slots[i % n_slots].copy_(self.host[i])
                carry = fn(blocks[i % n_slots], carry, *args)
            return carry
        compute = torch.cuda.current_stream(self.device)
        copied, done = [None] * n_slots, [None] * n_slots
        self.copy_stream.wait_stream(compute)  # the slots' memory may have served earlier compute

        def issue(i):
            s = i % n_slots
            with torch.cuda.stream(self.copy_stream):
                if done[s] is not None:
                    self.copy_stream.wait_event(done[s])  # the compute that last read slot s
                slots[s].copy_(self.host[i], non_blocking=True)
                copied[s] = self.copy_stream.record_event()

        for i in range(start, min(start + self.lookahead, self.n)):
            issue(i)
        for i in range(start, self.n):
            if i + self.lookahead < self.n:
                issue(i + self.lookahead)
            s = i % n_slots
            compute.wait_event(copied[s])
            carry = fn(blocks[s], carry, *args)
            done[s] = compute.record_event()
        return carry


def _dual(blk, carry, temb, rot):
    return blk(carry[0], carry[1], temb, rot)


def _single(blk, x, temb, rot):
    return blk(x, temb, rot)


class OffloadedFluxForward:
    """Offloaded forward of ``FluxTransformer2DModel``: the embeddings and
    the head stay on the card, both block stacks stream from host memory::

        off = OffloadedFluxForward(model)  # the blocks move to host memory, the card's stacks are freed
        velocity = off(lat, txt, pooled, t, img_ids, txt_ids, guidance)
    """

    def __init__(self, model, lookahead: int = 1):
        cfg = model.cfg
        self.dual = BlockStreamer(model.transformer_blocks, cfg.num_layers, lookahead=lookahead)
        self.single = BlockStreamer(model.single_transformer_blocks, cfg.num_single_layers, lookahead=lookahead)
        self.model = _release_stacks(model)

    @torch.no_grad()
    def __call__(self, hidden_states, encoder_hidden_states, pooled_projections, timestep, img_ids, txt_ids,
                 guidance=None):
        m = self.model
        img, txt, temb, rot = m.embed(hidden_states, encoder_hidden_states, pooled_projections, timestep, img_ids,
                                      txt_ids, guidance)
        img, txt = self.dual.run(_dual, (img, txt), temb, rot)
        s_txt = txt.shape[1]
        x = self.single.run(_single, torch.cat([txt, img], dim=1), temb, rot)
        return m.head(x[:, s_txt:], temb)


class OffloadedCachedFluxForward:
    """The first-block cache over an offloaded FLUX forward (JAX :106-193):
    dual block 0, the cache's decision block, stays on the card; the other
    dual and all single blocks stream. The decision is one host read a step
    (``caching.fbcache._similar``); a hit replays the cached residuals and
    streams no block. Store-on-miss, as the port's FB cache: hits compare
    against the last miss's residual. ``hits`` / ``steps`` count the calls."""

    def __init__(self, model, lookahead: int = 1, residual_diff_threshold: float = 0.12):
        cfg = model.cfg
        self.threshold = residual_diff_threshold
        self.block0 = _own_copy(slice_module(model.transformer_blocks, 0))
        self.dual = BlockStreamer(model.transformer_blocks, cfg.num_layers, lookahead=lookahead)
        self.single = BlockStreamer(model.single_transformer_blocks, cfg.num_single_layers, lookahead=lookahead)
        self.model = _release_stacks(model)
        self._prev_first = None  # bf16 (B, S_img, D), dual block 0's residual at the last miss
        self._cached = None  # bf16 residuals (dual img, dual txt, single) of the last miss
        self.hits = 0
        self.steps = 0

    @torch.no_grad()
    def __call__(self, hidden_states, encoder_hidden_states, pooled_projections, timestep, img_ids, txt_ids,
                 guidance=None):
        m = self.model
        img0, txt0, temb, rot = m.embed(hidden_states, encoder_hidden_states, pooled_projections, timestep,
                                        img_ids, txt_ids, guidance)
        s_txt = txt0.shape[1]
        img1, txt1 = self.block0(img0, txt0, temb, rot)
        first_res = (img1 - img0).to(torch.bfloat16)
        hit = self._prev_first is not None and _similar(first_res, self._prev_first, self.threshold)
        self.steps += 1
        if hit:
            self.hits += 1
            d_img, d_txt, d_single = self._cached
            x_f = torch.cat([txt1 + d_txt, img1 + d_img], dim=1) + d_single
        else:
            img_f, txt_f = self.dual.run(_dual, (img1, txt1), temb, rot, start=1)
            x1 = torch.cat([txt_f, img_f], dim=1)
            x_f = self.single.run(_single, x1, temb, rot)
            self._cached = ((img_f - img1).to(torch.bfloat16), (txt_f - txt1).to(torch.bfloat16),
                            (x_f - x1).to(torch.bfloat16))
            self._prev_first = first_res
        return m.head(x_f[:, s_txt:], temb)


class OffloadedQwenImageForward:
    """Offloaded forward of ``QwenImageTransformer2DModel`` (JAX :280-305):
    the embeddings and head stay on the card, the joint blocks stream."""

    def __init__(self, model, lookahead: int = 1):
        self.blocks = BlockStreamer(model.blocks, model.cfg.num_layers, lookahead=lookahead)
        self.model = _release_stacks(model)

    @torch.no_grad()
    def __call__(self, hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids=None):
        m = self.model
        img, txt, temb, rot = m.embed(hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids)
        img, _ = self.blocks.run(_dual, (img, txt), temb, rot)
        return m.head(img, temb)


class OffloadedCachedQwenImageForward:
    """Qwen-Image's first-blocks cache over an offloaded forward (JAX
    :196-277): the ``fn_blocks`` indicator blocks (8, the reference's
    Fn_compute_blocks; within [1, L - 1]) stay on the card, the others
    stream; a hit replays the cached image-stream residual and streams no
    block. Decision and store-on-miss as :class:`OffloadedCachedFluxForward`."""

    def __init__(self, model, lookahead: int = 1, residual_diff_threshold: float = 0.12, fn_blocks: int = 8):
        cfg = model.cfg
        self.threshold = residual_diff_threshold
        self.fn = max(1, min(int(fn_blocks), cfg.num_layers - 1))
        self.head_blocks = [_own_copy(slice_module(model.blocks, i)) for i in range(self.fn)]
        self.blocks = BlockStreamer(model.blocks, cfg.num_layers, lookahead=lookahead)
        self.model = _release_stacks(model)
        self._prev_first = None  # bf16 (B, S_img, D), the indicator blocks' image residual at the last miss
        self._cached = None  # bf16 image residual of blocks fn..L-1
        self.hits = 0
        self.steps = 0

    @torch.no_grad()
    def __call__(self, hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids=None):
        m = self.model
        img0, txt0, temb, rot = m.embed(hidden_states, encoder_hidden_states, timestep, img_ids, txt_ids)
        img, txt = img0, txt0
        for blk in self.head_blocks:
            img, txt = blk(img, txt, temb, rot)
        first_res = (img - img0).to(torch.bfloat16)
        hit = self._prev_first is not None and _similar(first_res, self._prev_first, self.threshold)
        self.steps += 1
        if hit:
            self.hits += 1
            img_f = img + self._cached
        else:
            img_f, _ = self.blocks.run(_dual, (img, txt), temb, rot, start=self.fn)
            self._cached = (img_f - img).to(torch.bfloat16)
            self._prev_first = first_res
        return m.head(img_f, temb)
