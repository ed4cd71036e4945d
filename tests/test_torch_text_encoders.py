"""The port's T5 (bf16 and AWQ W4A16) and CLIP text encoders and
``FluxPipeline.encode_prompt`` against the JAX package (CPU), with weights
from the JAX ``random_init`` carried across by ``t5_from_jax_params`` /
``clip_from_jax_params``.

Tolerance for encoder outputs: max error <= 2e-2 of the reference's max
|value| (bf16 outputs; XLA's and torch's softmax, tanh and sigmoid round
some values one bf16 step apart, and those steps travel through the
blocks). The relative-position buckets match exactly.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models.text_encoders.clip import CLIPTextModel as JaxCLIP
from nunchaku_tpu.models.text_encoders.t5 import T5EncoderModel as JaxT5
from nunchaku_tpu.models.text_encoders.t5 import t5_relative_position_bucket as jax_bucket
from nunchaku_tpu.pipeline.pipeline_flux import FluxPipeline as JaxPipeline
from nunchaku_tpu_torch.convert import clip_from_jax_params, t5_from_jax_params
from nunchaku_tpu_torch.models.linear import AWQW4A16Linear, Linear
from nunchaku_tpu_torch.models.text_encoders.clip import CLIPTextModel
from nunchaku_tpu_torch.models.text_encoders.t5 import T5EncoderModel, t5_relative_position_bucket
from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

T5_KW = dict(d_model=512, d_ff=1024, d_kv=64, heads=8, layers=2)  # bench.py's tiny T5
CLIP_KW = dict(vocab=1000, d=128, heads=2, layers=2)


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


def _params(model):
    return {k: np.asarray(v) for k, v in model.named_parameters()}


def stub_tokenizer(vocab, eos=2):
    """A deterministic stand-in tokenizer: each word -> 3 + crc32 % (vocab - 3),
    then ``eos``, padded with 0 to ``max_length`` -> (B, max_length) int32."""
    def tokenize(prompts, max_length):
        ids = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            toks = [3 + zlib.crc32(w.encode()) % (vocab - 3) for w in p.split()][:max_length - 1] + [eos]
            ids[i, :len(toks)] = toks
        return ids
    return tokenize


@pytest.fixture(scope="module")
def t5_pairs():
    out = {}
    for quantized in (False, True):
        jm = JaxT5.random_init(jax.random.PRNGKey(0), quantized=quantized, **T5_KW)
        out[quantized] = (jm, t5_from_jax_params(_params(jm), heads=8, d_kv=64, device="cpu"))
    return out


@pytest.fixture(scope="module")
def clip_pair():
    jm = JaxCLIP.random_init(jax.random.PRNGKey(1), **CLIP_KW)
    return jm, clip_from_jax_params(_params(jm), heads=2, device="cpu")


@pytest.mark.parametrize("s", [77, 512, 700])
def test_relative_position_bucket_exact(s):
    pos = np.arange(s)
    rel = pos[None, :] - pos[:, None]
    ref = np.asarray(jax_bucket(jnp.asarray(rel)))
    np.testing.assert_array_equal(t5_relative_position_bucket(torch.from_numpy(rel)).numpy(), ref)


@pytest.mark.parametrize("quantized", [False, True])
def test_t5_matches_jax(t5_pairs, quantized):
    jm, tm = t5_pairs[quantized]
    ids = np.random.default_rng(40).integers(0, 32128, (2, 77)).astype(np.int32)
    ref = jm(jnp.asarray(ids))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long())
    assert out.shape == (2, 77, 512) and out.dtype == torch.bfloat16
    assert isinstance(tm.blocks[0].attn.q, AWQW4A16Linear if quantized else Linear)
    assert _rel(out, ref) <= 2e-2


def test_clip_matches_jax(clip_pair):
    """Pooled at each row's first eos (2): row 0 at 10, row 1 at 40 (a
    second eos at 76 is not the one); the hidden states too."""
    jm, tm = clip_pair
    ids = np.random.default_rng(41).integers(3, 1000, (2, 77)).astype(np.int32)
    ids[0, 10], ids[1, 40], ids[1, 76] = 2, 2, 2
    ref_pooled, ref_hidden = jm(jnp.asarray(ids))
    with torch.no_grad():
        pooled, hidden = tm(torch.from_numpy(ids).long())
    assert pooled.shape == (2, 128) and hidden.shape == (2, 77, 128)
    assert torch.equal(pooled[1], hidden[1, 40])
    assert _rel(pooled, ref_pooled) <= 2e-2 and _rel(hidden, ref_hidden) <= 2e-2


@pytest.mark.parametrize("kind", ["t5", "t5_awq", "clip"])
def test_random_init_mirrors_the_jax_parameter_tree(kind):
    """Same parameter names, shapes and dtypes as the JAX encoder (T5's
    linears without bias; rel_bias on block 0 only)."""
    if kind == "clip":
        jm = JaxCLIP.random_init(jax.random.PRNGKey(2), **CLIP_KW)
        tm = CLIPTextModel.random_init(seed=0, device="cpu", **CLIP_KW)
    else:
        jm = JaxT5.random_init(jax.random.PRNGKey(2), quantized=kind == "t5_awq", **T5_KW)
        tm = T5EncoderModel.random_init(quantized=kind == "t5_awq", seed=0, device="cpu", **T5_KW)
    ours = {n: (tuple(b.shape), str(b.dtype).replace("torch.", "")) for n, b in tm.named_buffers()}
    if kind != "clip":  # the port keeps the RMSNorm weights as plain buffers
        ours = {n.replace(".ln1", ".ln1.weight").replace(".ln2", ".ln2.weight").replace(
            "final_norm", "final_norm.weight"): v for n, v in ours.items()}
    theirs = {n: (tuple(a.shape), str(a.dtype)) for n, a in _params(jm).items()}
    assert ours == theirs


def test_converter_refuses_leftovers():
    jm = JaxT5.random_init(jax.random.PRNGKey(3), quantized=True, **T5_KW)
    with pytest.raises(KeyError):
        t5_from_jax_params({**_params(jm), "extra.weight": np.zeros(1)}, heads=8, d_kv=64, device="cpu")
    jc = JaxCLIP.random_init(jax.random.PRNGKey(3), **CLIP_KW)
    with pytest.raises(KeyError):
        clip_from_jax_params({**_params(jc), "extra": np.zeros(1)}, heads=2, device="cpu")


def test_encode_prompt_matches_jax(t5_pairs, clip_pair):
    """T5 ids at 512, CLIP ids at 77, from the same stand-in tokenizers."""
    (jt5, tt5), (jclip, tclip) = t5_pairs[True], clip_pair
    tok_t5, tok_clip = stub_tokenizer(32128, eos=1), stub_tokenizer(1000)
    prompts = ["an aerial photograph of a coastal city at dawn", "a cat"]
    ref_pe, ref_pooled = JaxPipeline(None, text_encoder=jclip, text_encoder_2=jt5, tokenizer=tok_clip,
                                     tokenizer_2=tok_t5).encode_prompt(prompts)
    pipe = FluxPipeline(None, text_encoder=tclip, text_encoder_2=tt5, tokenizer=tok_clip, tokenizer_2=tok_t5)
    pe, pooled = pipe.encode_prompt(prompts)
    assert pe.shape == (2, 512, 512) and pooled.shape == (2, 128)
    assert _rel(pe, ref_pe) <= 2e-2 and _rel(pooled, ref_pooled) <= 2e-2
    one, _ = pipe.encode_prompt("a cat")
    assert torch.equal(one[0], pe[1])


def test_pipeline_from_a_prompt(t5_pairs, clip_pair):
    """``FluxPipeline(prompt=...)`` encodes, then runs as from the
    embeddings; without encoders it raises."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel

    cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, joint_attention_dim=512,
                     pooled_projection_dim=128, precision="w4a8")
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device="cpu")
    pipe = FluxPipeline(model, text_encoder=clip_pair[1], text_encoder_2=t5_pairs[True][1],
                        tokenizer=stub_tokenizer(1000), tokenizer_2=stub_tokenizer(32128, eos=1))
    kw = dict(height=128, width=128, num_inference_steps=1, seed=3)
    out = pipe(prompt="a red bicycle", **kw).latents
    pe, pooled = pipe.encode_prompt("a red bicycle")
    assert torch.equal(out, pipe(prompt_embeds=pe, pooled_prompt_embeds=pooled, **kw).latents)
    with pytest.raises(ValueError, match="without text encoders"):
        FluxPipeline(model)(prompt="a red bicycle", **kw)
