"""Port parity, attention kernels and layers: the plain versions of K3
(``flash_attention``) and K4 (``flash_decode``) against the JAX package's
Pallas kernels run in interpret mode (``repro.kernels.ops``, as
``tests/test_kernels.py`` runs them), and the transformer's layers against
``repro.models.layers``. Inputs are made by numpy from a seed and fed to both
packages. The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here every wrapper gets CPU tensors."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as j_ops
from repro.models import layers as j_layers

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention, kernel_symbol
from repro_torch.kernels.flash_decode import TARGET_BLOCKS, TILE, flash_decode, split_plan
from repro_torch.models import layers

F32_TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_kernels.py:14-15
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _both(x, dtype="f32"):
    """One numpy array as a JAX array and a torch tensor of the same dtype
    (bf16 rounds the same f32 values in both)."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(np.array(x, np.float32)).to(td)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# K3 flash_attention: the cases of tests/test_kernels.py:58-81
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,kv,hd,blk", [
    (1, 128, 4, 4, 32, 64),     # MHA
    (2, 256, 8, 2, 16, 64),     # GQA 4x
    (1, 192, 6, 3, 64, 64),     # ragged-ish heads
])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_pallas(rng, b, s, h, kv, hd, blk, window, dtype):
    jq, tq = _both(rng.normal(0, 1, (b, s, h, hd)), dtype)
    jk, tk = _both(rng.normal(0, 1, (b, s, kv, hd)), dtype)
    jv, tv = _both(rng.normal(0, 1, (b, s, kv, hd)), dtype)
    want = j_ops.flash_attention(jq, jk, jv, causal=True, window=window, blk_q=blk,
                                 blk_k=blk)
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, DTYPES[dtype][2])
    _close(ref.flash_attention_ref(tq, tk, tv, causal=True, window=window), want,
           DTYPES[dtype][2])


def test_flash_attention_non_causal_matches_pallas(rng):
    jq, tq = _both(rng.normal(0, 1, (1, 128, 4, 32)))
    jk, tk = _both(rng.normal(0, 1, (1, 128, 4, 32)))
    jv, tv = _both(rng.normal(0, 1, (1, 128, 4, 32)))
    want = j_ops.flash_attention(jq, jk, jv, causal=False, blk_q=64, blk_k=64)
    _close(flash_attention(tq, tk, tv, causal=False), want, F32_TOL)


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (100, 100, True, 0, 0),     # ragged: not a multiple of the 32-row chunk
    (37, 90, False, 0, 0),
    (70, 70, True, 20, 0),
    (17, 81, True, 0, 64),      # continuation: q starts at position 64
])
def test_flash_attention_ragged_matches_mea(rng, sq, sk, causal, window, q_offset):
    """Where the Pallas kernel asserts block-aligned lengths, the plain
    version follows ``layers.mea_attention``'s padding and masking."""
    jq, tq = _both(rng.normal(0, 1, (2, sq, 4, 32)))
    jk, tk = _both(rng.normal(0, 1, (2, sk, 2, 32)))
    jv, tv = _both(rng.normal(0, 1, (2, sk, 2, 32)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, query_chunk=32, kv_chunk=32)
    want = j_layers.mea_attention(jq, jk, jv, **kw)
    _close(flash_attention(tq, tk, tv, **kw), want, F32_TOL)
    _close(layers.mea_attention(tq, tk, tv, **kw), want, F32_TOL)


@pytest.mark.parametrize("window", [0, 20])
def test_naive_attention_matches(rng, window):
    jq, tq = _both(rng.normal(0, 1, (2, 40, 4, 16)))
    jk, tk = _both(rng.normal(0, 1, (2, 40, 2, 16)))
    jv, tv = _both(rng.normal(0, 1, (2, 40, 2, 16)))
    want = j_layers.naive_attention(jq, jk, jv, causal=True, window=window)
    _close(layers.naive_attention(tq, tk, tv, causal=True, window=window), want, F32_TOL)


# ---------------------------------------------------------------------------
# K4 flash_decode: the cases of tests/test_kernels.py:89-117
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,kv,hd,s,blk", [
    (2, 8, 4, 32, 256, 64),
    (1, 4, 4, 64, 512, 128),
    (3, 6, 2, 16, 128, 128),
])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_matches_pallas(rng, b, h, kv, hd, s, blk, window, dtype):
    jk, tk = _both(rng.normal(0, 1, (b, kv, s, hd)), dtype)
    jv, tv = _both(rng.normal(0, 1, (b, kv, s, hd)), dtype)
    jq, tq = _both(rng.normal(0, 1, (b, h, hd)), dtype)
    fill = int(0.8 * s)
    kpos = np.where(np.arange(s) < fill, np.arange(s), -1).astype(np.int32)
    want = j_ops.flash_decode(jq, jk, jv, jnp.asarray(kpos), fill - 1, window=window,
                              blk_s=blk)
    tpos = torch.from_numpy(kpos)
    got = flash_decode(tq, tk, tv, tpos, fill - 1, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, DTYPES[dtype][2])
    _close(ref.flash_decode_ref(tq, tk, tv, tpos, fill - 1, window=window), want,
           DTYPES[dtype][2])


def test_flash_decode_ring_buffer_positions(rng):
    """Ring cache: slot positions wrap; masking goes by position value."""
    s, written = 64, 100
    kpos = layers.cache_slot_positions(written, s, ring=True)
    jk, tk = _both(rng.normal(0, 1, (1, 2, s, 16)))
    jv, tv = _both(rng.normal(0, 1, (1, 2, s, 16)))
    jq, tq = _both(rng.normal(0, 1, (1, 4, 16)))
    want = j_ops.flash_decode(jq, jk, jv, jnp.asarray(kpos.numpy()), written - 1,
                              window=s, blk_s=32)
    _close(flash_decode(tq, tk, tv, kpos, written - 1, window=s), want, F32_TOL)
    want = j_layers.decode_attention(jq, jk, jv, jnp.asarray(kpos.numpy()), written - 1,
                                     window=s)
    _close(layers.decode_attention(tq, tk, tv, kpos, written - 1, window=s), want, F32_TOL)


@pytest.mark.parametrize("b,kvh,groups,s", [(4, 8, 5, 1056), (1, 2, 2, 10), (2, 8, 12, 100)])
def test_flash_decode_split_plan_covers_the_cache(b, kvh, groups, s):
    """The wrapper's slices cover every slot once, none empty."""
    nsplit, chunk = split_plan(b, kvh, groups, s)
    assert nsplit >= 1 and (nsplit - 1) * chunk < s <= nsplit * chunk


@pytest.mark.parametrize("s,want", [(1056, (9, 128)), (512, (8, 64))])
def test_flash_decode_split_plan_at_the_serving_shape(s, want):
    """Qwen2.5-14B's decode step (B 4, KV 8, 5 query heads per KV head):
    the 1,056-slot cache of the serving run and a 512-slot ring. Slices are
    whole 64-slot tiles, none empty, and the blocks reach ``TARGET_BLOCKS``
    (or one tile per slice, when the cache has fewer) while fitting one wave
    of three blocks per SM on the H100's 132."""
    b, kvh, groups = 4, 8, 5
    nsplit, chunk = split_plan(b, kvh, groups, s)
    assert (nsplit, chunk) == want
    assert chunk % TILE == 0
    assert (nsplit - 1) * chunk < s <= nsplit * chunk
    blocks = nsplit * b * kvh
    tiles = -(-s // TILE)
    assert min(TARGET_BLOCKS, tiles * b * kvh) <= blocks <= 3 * 132


def test_flash_attention_dispatches_by_dtype():
    """bf16 runs the wgmma kernel, f32 the 3xTF32 mma.sync one; nothing
    else has a kernel."""
    assert kernel_symbol(torch.bfloat16) == "flash_attention_bf16_launch"
    assert kernel_symbol(torch.float32) == "flash_attention_f32_launch"
    with pytest.raises(TypeError, match="f32 or bf16"):
        kernel_symbol(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wrapper_errors_on_meta_tensors(dtype):
    """Off the host the wrapper checks its inputs before it looks for a card:
    an unsupported head dim raises for both dtypes, a supported one reaches
    the device check."""
    assert 48 not in HEAD_DIMS
    q = torch.empty((1, 64, 4, 48), device="meta", dtype=dtype)
    k = torch.empty((1, 64, 2, 48), device="meta", dtype=dtype)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(q, k, k)
    q = torch.empty((1, 64, 4, 64), device="meta", dtype=dtype)
    k = torch.empty((1, 64, 2, 64), device="meta", dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, k)
    with pytest.raises(TypeError, match="f32 or bf16"):
        flash_attention(q.to(torch.float16), k.to(torch.float16), k.to(torch.float16))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_no_valid_slot_matches_pallas(rng, dtype):
    """Every slot's position lies above ``q_position``: the TPU kernel scores
    every slot -1e30, so each gets p = 1 and the row is the mean of V over
    all slots. The plain version (the kernel's yardstick on the card) gives
    the same."""
    b, h, kv, hd, s = 2, 8, 4, 32, 256
    jk, tk = _both(rng.normal(0, 1, (b, kv, s, hd)), dtype)
    jv, tv = _both(rng.normal(0, 1, (b, kv, s, hd)), dtype)
    jq, tq = _both(rng.normal(0, 1, (b, h, hd)), dtype)
    kpos = np.arange(s, dtype=np.int32) + 10
    want = j_ops.flash_decode(jq, jk, jv, jnp.asarray(kpos), 5, blk_s=64)
    got = flash_decode(tq, tk, tv, torch.from_numpy(kpos), 5)
    _close(got, want, DTYPES[dtype][2])
    mean = tv.float().mean(dim=2).repeat_interleave(h // kv, dim=1)
    _close(got, mean.numpy(), DTYPES[dtype][2])


def test_wrappers_raise_off_the_host_without_a_card():
    """A tensor that is not on the CPU launches the kernel or raises: the
    wrappers never fall back to the plain version."""
    q = torch.empty((1, 64, 4, 32), device="meta")
    k = torch.empty((1, 64, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, k)
    kc = torch.empty((1, 2, 64, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(torch.empty((1, 4, 32), device="meta"), kc, kc,
                     torch.empty((64,), dtype=torch.int32, device="meta"), 10)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rmsnorm_and_head_rmsnorm_match(rng):
    jx, tx = _both(rng.normal(0, 2, (2, 5, 64)))
    js, ts = _both(rng.normal(1, 0.1, (64,)))
    want = j_layers.rmsnorm({"scale": js}, jx, 1e-5)
    _close(layers.rmsnorm({"scale": ts}, tx, 1e-5), want, LAYER_TOL)
    jh, th = _both(rng.normal(0, 2, (2, 5, 4, 16)))
    js, ts = _both(rng.normal(1, 0.1, (16,)))
    _close(layers.head_rmsnorm(ts, th, 1e-6), j_layers.head_rmsnorm(js, jh, 1e-6),
           LAYER_TOL)


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_apply_rope_matches(rng, theta):
    jx, tx = _both(rng.normal(0, 1, (2, 12, 4, 32)))
    pos = np.stack([np.arange(12), np.arange(40, 52)]).astype(np.int32)
    want = j_layers.apply_rope(jx, jnp.asarray(pos), theta)
    _close(layers.apply_rope(tx, torch.from_numpy(pos), theta), want, LAYER_TOL)


def test_linear_and_mlp_match(rng):
    jx, tx = _both(rng.normal(0, 1, (2, 3, 16)))
    w = {k: _both(rng.normal(0, 0.25, shape)) for k, shape in
         (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    want = j_layers.mlp({k: v[0] for k, v in w.items()}, jx)
    _close(layers.mlp({k: v[1] for k, v in w.items()}, tx), want, LAYER_TOL)
    jb, tb = _both(rng.normal(0, 1, (24,)))
    want = j_layers.linear({"w": w["wi"][0], "b": jb}, jx)
    _close(layers.linear({"w": w["wi"][1], "b": tb}, tx), want, LAYER_TOL)


@pytest.mark.parametrize("pos,ring", [(0, False), (5, False), (7, False),
                                      (3, True), (8, True), (21, True)])
def test_cache_slot_positions_exact(pos, ring):
    want = np.asarray(j_layers.cache_slot_positions(jnp.asarray(pos), 8, ring))
    got = layers.cache_slot_positions(pos, 8, ring)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos,ring", [(3, False), (13, True)])
def test_cache_write_matches(rng, pos, ring):
    jk, tk = _both(rng.normal(0, 1, (2, 3, 8, 16)))
    jv, tv = _both(rng.normal(0, 1, (2, 3, 8, 16)))
    jkn, tkn = _both(rng.normal(0, 1, (2, 3, 16)))
    jvn, tvn = _both(rng.normal(0, 1, (2, 3, 16)))
    want_k, want_v = j_layers.cache_write(jk, jv, jnp.asarray(pos), jkn, jvn, ring)
    got_k, got_v = layers.cache_write(tk, tv, pos, tkn, tvn, ring)
    assert got_k is tk and got_v is tv        # written in place
    _close(got_k, want_k, LAYER_TOL)
    _close(got_v, want_v, LAYER_TOL)
