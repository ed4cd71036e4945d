"""Sequence parallelism over ``torch.distributed`` (``sp``): the ring
attention and the sequence-parallel forwards of FLUX, Qwen-Image and
Z-Image."""

from .sp import (combine_result, combine_shard, parallelize_sequence, parallelize_sequence_qwenimage,
                 parallelize_sequence_zimage, ring_attention)

__all__ = ["combine_result", "combine_shard", "parallelize_sequence", "parallelize_sequence_qwenimage",
           "parallelize_sequence_zimage", "ring_attention"]
