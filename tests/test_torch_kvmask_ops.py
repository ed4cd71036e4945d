"""The kv-mask forms of the port's two flash kernels (fixed-shift and online
softmax) and of ``FluxAttention`` against the JAX package on the CPU.

The JAX ``flash_attention(kv_mask=)`` runs ``_flash_kernel_fixed`` /
``_flash_kernel`` in Pallas interpret mode (``bq = bkv = 128``, so a
masked column can sit inside the first kv tile); the port's wrappers run
their plain twins on CPU tensors. Inputs come from seeded numpy generators.

Tolerances: attention outputs (bf16) within 1e-2 of the reference's max
|value| (p and the output rounded to bf16; exp2 and the sums in another
order; the online twin rescales at other kv columns than a 128-wide JAX
tile); the attention modules within 2e-2 (int8 codes, bf16 q/k/v, as
tests/test_torch_modules.py). Two properties are exact: a masked column
adds nothing (the output does not change when its v is made huge), and an
all-True mask gives the unmasked output bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nunchaku_tpu.models import attention as jatt
from nunchaku_tpu.models import embeddings as jemb
from nunchaku_tpu.ops import attention as jops_att
from nunchaku_tpu_torch.models import attention as tatt
from nunchaku_tpu_torch.ops import attention as tops_att
from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

from test_torch_turbo_ops import _bf16, _rel, _t, port_attention

D = 128
# name -> (B, H, S_txt, S_img, valid text tokens per batch row, or None: an additive bias)
CASES = {
    # S 201 is ragged; row 1's padded columns [20, 45) lie inside the first kv tile
    "bool_ragged": (2, 2, 45, 156, (45, 20)),
    # row 1's whole text block is padding: its first 128-column kv tile is all masked
    "bool_first_tile_masked": (2, 2, 150, 106, (150, 0)),
    # an f32 log2-domain bias: a spread in [-6, 0], and -1e30 on some text columns
    "additive": (2, 2, 64, 136, None),
}


def _case_inputs(name):
    b, h, s_txt, s_img, valid = CASES[name]
    s = s_txt + s_img
    rng = np.random.default_rng(sorted(CASES).index(name))
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    q = bf(rng.standard_normal((b, h, s, D)) * 0.25)  # prescaled: logits of std ~4 in the log2 domain
    k = bf(rng.standard_normal((b, h, s, D)) * 2.0)
    v = bf(rng.standard_normal((b, h, s, D)))
    if valid is None:
        mask = -6.0 * rng.random((b, s)).astype(np.float32)
        mask[:, :s_txt][rng.random((b, s_txt)) < 0.3] = tops_att.NEG_INF
    else:
        mask = np.ones((b, s), bool)
        for i, n in enumerate(valid):
            mask[i, n:s_txt] = False
    return q, k, v, mask


@pytest.fixture(scope="module")
def refs():
    """JAX outputs per (case, fixed_softmax)."""
    out = {}
    for name in CASES:
        q, k, v, mask = _case_inputs(name)
        for fixed in (True, False):
            ref = jops_att.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=1.0,
                                           out_bshd=True, fixed_softmax=fixed, kv_mask=jnp.asarray(mask),
                                           bq=128, bkv=128)
            out[(name, fixed)] = np.asarray(ref, np.float32)
    return out


def _port(q, k, v, mask, fixed):
    if fixed:
        return tops_att.flash_attention(q, k, v, mask)
    return tops_att.flash_attention_online(q, k, v, scale=1.0, kv_mask=mask, out_bshd=True)


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "online"])
@pytest.mark.parametrize("name", list(CASES))
def test_masked_twin_matches_pallas(refs, name, fixed):
    q, k, v, mask = _case_inputs(name)
    reset_launch_counts()
    out = _port(_t(q), _t(k), _t(v), torch.from_numpy(mask), fixed)
    b, h, s, _ = q.shape
    assert out.shape == (b, s, h * D) and out.dtype == torch.bfloat16
    assert _rel(out, refs[(name, fixed)]) <= 1e-2
    assert all(n == 0 for n in launch_counts().values())  # CPU tensors: the twins, no launch


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "online"])
@pytest.mark.parametrize("name", ["bool_ragged", "bool_first_tile_masked"])
def test_masked_columns_add_nothing(name, fixed):
    """p of a masked column is exactly 0: making its v huge changes no output
    bit; and each batch row equals attention over its unmasked keys alone."""
    q, k, v, mask = _case_inputs(name)
    q, k, v, mask = _t(q), _t(k), _t(v), torch.from_numpy(mask)
    out = _port(q, k, v, mask, fixed)
    v_big = v.clone()
    v_big.transpose(1, 2)[~mask] = 1e4
    assert torch.equal(_port(q, k, v_big, mask, fixed), out)
    for i in range(q.shape[0]):
        keep = mask[i]
        alone = _port(q[i:i + 1], k[i:i + 1, :, keep], v[i:i + 1, :, keep], None, fixed)
        assert _rel(out[i:i + 1], alone) <= 1e-2


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "online"])
def test_all_true_mask_is_no_mask(fixed):
    q, k, v = (_t(x) for x in _case_inputs("bool_ragged")[:3])
    ones = torch.ones((q.shape[0], k.shape[2]), dtype=torch.bool)
    assert torch.equal(_port(q, k, v, ones, fixed), _port(q, k, v, None, fixed))


def test_kv_bias():
    mask = torch.tensor([[True, False, True]])
    bias = tops_att.kv_bias(mask, 1, 3)
    assert bias.dtype == torch.float32 and torch.equal(bias, torch.tensor([[0.0, tops_att.NEG_INF, 0.0]]))
    assert torch.equal(tops_att.kv_bias(torch.zeros((1, 3), dtype=torch.bfloat16), 1, 3), torch.zeros((1, 3)))
    with pytest.raises(ValueError):
        tops_att.kv_bias(mask, 1, 4)


# ---------------------------------------------------------------------------
# FluxAttention with a kv mask: the unfused branch (fixed and online
# softmax) and the fused prologue
# ---------------------------------------------------------------------------

S_TXT, S_IMG = 40, 88


def _module_inputs(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, S_TXT + S_IMG), bool)
    mask[1, 13:S_TXT] = False
    ids = np.zeros((S_TXT + S_IMG, 3), np.int32)
    ids[:, 2] = np.arange(ids.shape[0])
    return rng, mask, jemb.rope_table(jnp.asarray(ids), (16, 56, 56))


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "online"])
def test_masked_flux_attention_matches_jax(fixed):
    ja = jatt.FluxAttention.random_init(jax.random.PRNGKey(11), 256, 2, 128, joint=True, precision="w4a8")
    ta = port_attention(ja)
    ja.fixed_softmax = ta.fixed_softmax = fixed
    rng, mask, rot = _module_inputs(80)
    img = jnp.asarray(rng.standard_normal((2, S_IMG, 256)), jnp.float32)
    txt = jnp.asarray(rng.standard_normal((2, S_TXT, 256)), jnp.float32)
    ref = ja(img, txt, rot, kv_mask=jnp.asarray(mask))
    out = ta(_t(img), _t(txt), _t(rot), kv_mask=torch.from_numpy(mask))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        assert _rel(o, r) <= 2e-2


def test_masked_fused_flux_attention_matches_jax():
    """The fused prologue (qkv/RoPE producer into one joint buffer, LN +
    modulate in the projections) with a mask; it always takes the fixed
    shift, as in JAX."""
    ja = jatt.FluxAttention.random_init(jax.random.PRNGKey(12), 256, 2, 128, joint=True, precision="w4a8")
    ta = port_attention(ja)
    jatt.permute_qk_halfsplit(ja)
    ja.prep_producer = True
    tatt.permute_qk_halfsplit(ta)
    rng, mask, rot = _module_inputs(81)
    rot = jops_att.rope_table_halfsplit(rot)
    img = _bf16(rng, (2, S_IMG, 256), 2.0)
    txt = _bf16(rng, (2, S_TXT, 256), 2.0)
    mods = tuple((jnp.asarray(rng.standard_normal((2, 256)) * 0.3 + 0.5, jnp.float32),
                  jnp.asarray(rng.standard_normal((2, 256)) * 0.3 + 1.0, jnp.float32)) for _ in range(2))
    ref = ja(img, txt, rot, mods=mods, kv_mask=jnp.asarray(mask))
    out = ta(_t(img), _t(txt), tuple(map(_t, rot)), mods=tuple(tuple(map(_t, m)) for m in mods),
             kv_mask=torch.from_numpy(mask))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        assert _rel(o, r) <= 2e-2
