"""PyTorch + CUDA port of nunchaku_tpu for NVIDIA Hopper (H100).

The port runs the FLUX.1 w4a8 path from prompt embeddings to an image:
packed int4 SVDQuant weights dequantized to per-channel int8, int8 x int8
products, the first-block step caches, a tiled VAE decode, and the JAX
package's Pallas kernels rewritten as hand-written CUDA kernels for
``sm_90a`` (``csrc/``). It imports neither JAX nor ``nunchaku_tpu``.
Entry points place their tensors on the card unless asked for the CPU;
on the CPU every kernel wrapper runs its plain PyTorch twin.
"""

__version__ = "0.1.0"
