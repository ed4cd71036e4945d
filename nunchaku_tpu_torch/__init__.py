"""PyTorch + CUDA port of nunchaku_tpu for NVIDIA Hopper (H100).

The port runs FLUX.1, Qwen-Image, SANA and Z-Image, from nunchaku checkpoints
or random weights, and SDXL's int4 UNet from random or converted weights, to an image: 4-bit SVDQuant weights (int4 or nvfp4 products, or
packed codes dequantized to per-channel int8 for int8 x int8 products), the
text encoders, the first-block step caches and TeaCache, image-conditioned
requests (FLUX.1 Kontext / Fill / Canny-Depth, Qwen-Image edit) through the
VAE encoder, LoRA on the quantized FLUX model, block offloading
(``utils.offload``), a tiled VAE decode, and the JAX
package's Pallas kernels rewritten as hand-written CUDA kernels for
``sm_90a`` (``csrc/``). It imports neither JAX nor ``nunchaku_tpu``.
Entry points place their tensors on the card unless asked for the CPU;
on the CPU every kernel wrapper runs its plain PyTorch twin.

Public surface, under the JAX package's top-level names: the models
(``FluxTransformer2DModel``, ``QwenImageTransformer2DModel``,
``SDXLUNet2DConditionModel`` with ``SDXLConfig``, ``SanaTransformer2DModel``
with ``SanaConfig``, ``ZImageTransformer2DModel`` with ``ZImageConfig``, ``T5EncoderModel``, ``CLIPTextModel``, ``Gemma2Encoder``,
``AutoencoderKL``, ``DCAE`` with ``DCAEConfig``), their checkpoint loaders
(``load_flux_transformer``, ``load_qwenimage_transformer``,
``load_sana_transformer``, ``load_zimage_transformer``, ``load_t5_encoder``, ``load_clip_text``,
``load_gemma2_encoder``, ``load_autoencoder``, ``load_dc_ae``; each takes
``device=``, the card by default), the pipelines (with ``zimage_sigmas`` and FLUX's
``apply_cache_on_pipe``), the precision dials
``requantize_model`` / ``w4a8_cache_dequant`` and FLUX's LoRA entry points
``update_lora_params`` / ``set_lora_strength`` / ``compose_lora``.
"""

__version__ = "0.1.0"

from .models.autoencoder import AutoencoderKL, load_autoencoder
from .models.dc_ae import DCAE, DCAEConfig, load_dc_ae
from .models.linear import AWQW4A16Linear, SVDQW4A4Linear
from .models.loader import load_flux_transformer
from .models.loader_qwenimage import load_qwenimage_transformer
from .models.loader_sana import load_sana_transformer
from .models.loader_zimage import load_zimage_transformer
from .models.requantize import requantize_model, w4a8_cache_dequant
from .models.text_encoders.clip import CLIPTextModel, load_clip_text
from .models.text_encoders.gemma2 import Gemma2Encoder, load_gemma2_encoder
from .models.text_encoders.t5 import T5EncoderModel, load_t5_encoder
from .models.transformer_flux import FluxConfig, FluxTransformer2DModel
from .models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
from .models.transformer_sana import SanaConfig, SanaTransformer2DModel
from .models.transformer_zimage import ZImageConfig, ZImageTransformer2DModel
from .models.unet_sdxl import SDXLConfig, SDXLUNet2DConditionModel
from .lora.flux.apply import set_lora_strength, update_lora_params
from .lora.flux.convert import compose_lora
from .pipeline.pipeline_flux import FluxPipeline, apply_cache_on_pipe
from .pipeline.pipeline_qwenimage import QwenImagePipeline
from .pipeline.pipeline_sana import SanaPipeline
from .pipeline.pipeline_sdxl import SDXLPipeline
from .pipeline.pipeline_zimage import ZImagePipeline, zimage_sigmas
