"""Sequence parallelism of the port (``nunchaku_tpu_torch.parallel.sp``) on
CPU processes over gloo, against the port's single-process forwards and the
JAX package's ``shard_map`` forms.

The ranks run in spawned processes (``tests/torch_sp_worker.py``, torch
only): one 2-rank group runs the ring attention and the FLUX, Qwen-Image and
Z-Image forwards of tests/test_parallel.py's small int8 configurations (and
the two refusals), one 4-rank group the ring attention alone. JAX's
``ring_attention`` and ``parallelize_sequence`` run here on a 2-device mesh
of the virtual CPU devices (Pallas interpret mode).

Tolerances:
- ring attention against dense attention: 5e-3 absolute, tests/test_parallel.py's
  bound (bf16 partial outputs o_i, rescaled by their l_i and summed);
- the sequence-parallel forwards against the port's own single-process
  forward: 1e-2 relative (norm), JAX's bound for its own sharded forwards
  (per-token int8 codes are shard-invariant; the flash tiles' boundaries and
  the partial outputs' bf16 rounding move at the shard size);
- FLUX against JAX's ``parallelize_sequence`` on the same 2 shards: 1e-2
  relative (norm), JAX's bound.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_sp_worker as worker
from nunchaku_tpu.models.transformers.transformer_flux import FluxConfig as JaxFluxConfig
from nunchaku_tpu.models.transformers.transformer_flux import FluxTransformer2DModel as JaxFlux
from nunchaku_tpu.parallel import sp as jsp
from nunchaku_tpu_torch.convert import flux_from_jax_params, to_torch
from nunchaku_tpu_torch.models.transformer_flux import FluxConfig
from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
from nunchaku_tpu_torch.models.transformer_zimage import ZImageConfig, ZImageTransformer2DModel
from nunchaku_tpu_torch.ops.attention import flash_attention_denom_plain
from nunchaku_tpu_torch.ops.checks import damp_zimage_modulation

FLUX_SMALL = dict(num_layers=1, num_single_layers=1, num_attention_heads=2, joint_attention_dim=512,
                  pooled_projection_dim=256, precision="int8")
QWEN_SMALL = dict(num_layers=2, num_attention_heads=2, joint_attention_dim=320, precision="int8")
ZIMAGE_SMALL = dict(dim=512, num_layers=2, num_refiner_layers=1, num_attention_heads=4, cap_feat_dim=512,
                    ffn_inner=1024, precision="int8")
RING_S = 1024  # (1, 2, 1024, 128): 512- and 256-token shards


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm_rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def _grid_ids(n, w):
    ids = np.zeros((n, 3), np.int32)
    ids[:, 1] = np.arange(n) // w
    ids[:, 2] = np.arange(n) % w
    return ids


def _bf16(rng, shape, scale=1.0):
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16))


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(3)
    return tuple(_bf16(rng, (1, 2, RING_S, 128), 0.3) for _ in range(3))


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _flux_inputs():
    rng = np.random.default_rng(41)
    s_img, s_txt = 512, 64
    return (_bf16(rng, (1, s_img, 64)), _bf16(rng, (1, s_txt, 512)), _bf16(rng, (1, 256)),
            np.array([0.5], np.float32), _grid_ids(s_img, 32), np.zeros((s_txt, 3), np.int32),
            np.array([3.5], np.float32))


def _qwen_inputs():
    rng = np.random.default_rng(42)
    s_img, s_txt = 256, 32
    return (_bf16(rng, (1, s_img, 64)), _bf16(rng, (1, s_txt, 320)), np.array([0.5], np.float32),
            _grid_ids(s_img, 16), np.tile(np.arange(s_txt, dtype=np.int32)[:, None], (1, 3)))


def _zimage_inputs():
    rng = np.random.default_rng(43)
    s_img, s_txt = 256, 32
    ti = np.zeros((s_txt, 3), np.int32)
    ti[:, 0] = np.arange(s_txt)
    return (_bf16(rng, (1, s_img, 64)), _bf16(rng, (1, s_txt, 512)), np.array([0.5], np.float32),
            _grid_ids(s_img, 16), ti)


@pytest.fixture(scope="module")
def flux_pair():
    jm = JaxFlux.random_init(jax.random.PRNGKey(0), JaxFluxConfig(**FLUX_SMALL))
    tm = flux_from_jax_params({k: np.asarray(v) for k, v in jm.named_parameters()}, FluxConfig(**FLUX_SMALL),
                              device="cpu")
    return jm, tm


def _single_process(model, inputs):
    with torch.no_grad():
        return model(*[_t(a) for a in inputs])


def _damped_zimage():
    """The small Z-Image with its adaLN damped (``damp_zimage_modulation``,
    as every small Z-Image compared across implementations in this repo):
    undamped, its random tanh gates amplify int8 code flips so far that the
    bf16 rounding of two kv shards' partial outputs alone, combined in one
    process, moves the output by 1.0e-2."""
    model = ZImageTransformer2DModel.random_init(ZImageConfig(**ZIMAGE_SMALL), seed=6, device="cpu")
    damp_zimage_modulation(model)
    return model


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, qkv, flux_pair):
    """One 2-rank group: the ring over ``qkv`` and the three models'
    sequence-parallel forwards -> (rank results, single-process outputs)."""
    tmp = tmp_path_factory.mktemp("sp2")
    models = {"flux": (flux_pair[1], _flux_inputs()),
              "qwen": (QwenImageTransformer2DModel.random_init(QwenImageConfig(**QWEN_SMALL), seed=5, device="cpu"),
                       _qwen_inputs()),
              "zimage": (_damped_zimage(), _zimage_inputs())}
    single = {}
    for name, (model, inputs) in models.items():
        single[name] = _single_process(model, inputs)
        model._views = None  # the children build their own
        torch.save((model, tuple(_t(a) for a in inputs)), tmp / f"{name}.pt")
    ring_tmp = tmp / "ring"
    ring_tmp.mkdir()
    torch.save(tuple(_t(a) for a in qkv), ring_tmp / "qkv.pt")
    return worker.run_ranks("ring", 2, ring_tmp), worker.run_ranks("models", 2, tmp), single


def _jax_ring(qkv, n):
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("sp",))
    f = jax.shard_map(lambda q, k, v: jsp.ring_attention(q, k, v, "sp", interpret=True), mesh=mesh,
                      in_specs=(P(None, None, "sp", None),) * 3, out_specs=P(None, None, "sp", None),
                      check_vma=False)
    return np.asarray(jax.jit(f)(*map(jnp.asarray, qkv)), np.float32)


def _dense(qkv):
    return flash_attention_denom_plain(*(_t(a) for a in qkv), scale=None)[0].float().numpy()


def test_ring_two_ranks(two_ranks, qkv):
    """2 gloo ranks: within 5e-3 of the port's dense fixed-shift attention and
    of JAX's ring on a 2-device mesh; each rank's block in rank order."""
    ring = torch.cat(two_ranks[0], dim=2).float().numpy()
    assert ring.shape == (1, 2, RING_S, 128)
    np.testing.assert_allclose(ring, _dense(qkv), atol=5e-3, rtol=0)
    np.testing.assert_allclose(ring, _jax_ring(qkv, 2), atol=5e-3, rtol=0)


def test_ring_four_ranks(tmp_path, qkv):
    """4 gloo ranks (256-token shards): within 5e-3 of the dense attention;
    the denominators are shard-size invariant, so JAX's 2-device ring agrees
    too."""
    torch.save(tuple(_t(a) for a in qkv), tmp_path / "qkv.pt")
    ring = torch.cat(worker.run_ranks("ring", 4, tmp_path), dim=2).float().numpy()
    np.testing.assert_allclose(ring, _dense(qkv), atol=5e-3, rtol=0)
    np.testing.assert_allclose(ring, _jax_ring(qkv, 2), atol=5e-3, rtol=0)


def test_flux_sp_matches_single_process_and_jax(two_ranks, flux_pair):
    """FLUX int8 (1 + 1 blocks, 2 heads; S_img 512, S_txt 64 in 2 shards):
    the gathered output (every rank holds it) against the port's forward in
    one process and JAX's ``parallelize_sequence`` on a 2-device mesh."""
    outs, single = [r["flux"] for r in two_ranks[1]], two_ranks[2]["flux"]
    assert outs[0].shape == (1, 512, 64) and torch.equal(outs[0], outs[1])
    assert _norm_rel(outs[0].float(), single.float()) <= 1e-2
    jm = flux_pair[0]
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("sp",))
    replicated, fwd = jsp.parallelize_sequence(jm, mesh)
    try:
        ref = np.asarray(fwd(replicated, *map(jnp.asarray, _flux_inputs())), np.float32)
    finally:
        jsp._set_sp_axis(jm, None)
    assert _norm_rel(outs[0].float(), ref) <= 1e-2


@pytest.mark.parametrize("name,shape", [("qwen", (1, 256, 64)), ("zimage", (1, 256, 64))])
def test_qwen_zimage_sp_match_single_process(two_ranks, name, shape):
    """Qwen-Image (2 joint blocks, global ``txt_ids``) and Z-Image (1 + 1
    refiner blocks, 2 layers, adaLN damped; each stage's ring over its own
    tokens) at 2 ranks against the port's single-process forward."""
    outs, single = [r[name] for r in two_ranks[1]], two_ranks[2][name]
    assert tuple(outs[0].shape) == shape and torch.equal(outs[0], outs[1])
    assert _norm_rel(outs[0].float(), single.float()) <= 1e-2


def test_sp_refusals(two_ranks):
    """A sequence that 2 shards do not split, and the fused qkv prologue
    under sequence parallelism (its half-split rope table), raise on every
    rank."""
    for r in two_ranks[1]:
        assert r["indivisible"] is not None and "does not split" in r["indivisible"]
        assert r["fused"] is not None and "sequence parallelism" in r["fused"]
