# Copyright 2026 The kubeflow-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""The port's flash attention vs the reference's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the reference's
``flash_attention(..., interpret=True)`` runs the Pallas kernel in
interpret mode, as tests/test_flash_attention.py does. Same numpy-seeded
fp32 inputs; tolerance 2e-5 (fp32 statistics on both sides, summation
order differs).

The kernel itself runs only on a GPU: tests/test_torch_gpu.py holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import dense_attention as jax_dense
from kubeflow_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops.attention import dense_attention

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b=2, lq=64, lk=64, h=4, hkv=4, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, h, d), dtype=np.float32),
            rng.standard_normal((b, lk, hkv, d), dtype=np.float32),
            rng.standard_normal((b, lk, hkv, d), dtype=np.float32))


def _compare(q, k, v, mask=None, *, causal=False, block_q=32, block_k=32,
             scale=None):
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=block_q, block_k=block_k,
                    kv_segment_valid=None if mask is None
                    else jnp.asarray(mask), scale=scale, interpret=True)
    out = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale,
        kv_segment_valid=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    return out.numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_kernel(causal):
    _compare(*_qkv(0, lq=128, lk=128), causal=causal)


def test_uneven_blocks():
    q, k, v = _qkv(1, lq=64, lk=32)
    _compare(q, k, v, block_q=16, block_k=32)


def test_gqa():
    _compare(*_qkv(2, h=8, hkv=2), causal=True)


def test_key_mask():
    q, k, v = _qkv(3)
    mask = (np.arange(64)[None, :] < np.array([[23], [64]])).astype(np.int32)
    _compare(q, k, v, mask)


def test_fully_masked_row_gives_zero():
    q, k, v = _qkv(4)
    mask = np.ones((2, 64), np.int32)
    mask[1] = 0
    out = _compare(q, k, v, mask)
    assert np.all(out[1] == 0)


@pytest.mark.parametrize("scale", [0.0, -0.3])
def test_zero_and_negative_scale(scale):
    # The function is defined for any scale: the max is taken over the
    # scaled scores, so a negative scale favours the lowest score.
    q, k, v = _qkv(6)
    mask = (np.arange(64)[None, :] < np.array([[40], [64]])).astype(np.int32)
    _compare(q, k, v, mask, causal=True, scale=scale)


def test_ragged_length_plain_version():
    # L=100 is no multiple of the 64-key tile: the plain version's last
    # tile is ragged. The reference's own path for such a length is its
    # blockwise fallback.
    q, k, v = _qkv(5, lq=100, lk=100, h=4, hkv=2)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, interpret=True)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# A block of queries at an offset into a cache (a prefill chunk, a prefix
# hit's tail, the one-shot prompt at 0): the reference's dense_attention
# with q_offset, which its Pallas kernel does not take.


def _cache_block(seed, offset, h, hkv, l=40, extra=24, pads=(0, 7), d=16):
    """q [B, l, h, d] at ``offset`` over a cache of offset + l + extra
    slots (the block ends before the cache does), the validity the model
    builds: slots below the block's end and at or past the row's left
    pad."""
    s = offset + l + extra
    q, k, v = _qkv(seed, b=len(pads), lq=l, lk=s, h=h, hkv=hkv, d=d)
    slots = np.arange(s)[None, :]
    valid = (slots < offset + l) & (slots >= np.array(pads)[:, None])
    return q, k, v, valid


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1)])
@pytest.mark.parametrize("offset", [0, 20, 131, 448])
def test_offset_matches_reference_dense_attention(offset, h, hkv):
    """The kernel's plain version and the wrapper at a query offset
    against the reference's dense_attention(q_offset=..., kv_offset=0):
    fp32, 2e-5."""
    q, k, v, valid = _cache_block(offset + h, offset, h, hkv)
    want = np.asarray(jax_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=offset, kv_offset=0, kv_segment_valid=jnp.asarray(valid)))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    mask = torch.from_numpy(valid)
    plain = fa.flash_attention_reference(*args, causal=True, q_offset=offset,
                                         kv_segment_valid=mask)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    wrapped = fa.flash_attention(*args, causal=True, q_offset=offset,
                                 kv_segment_valid=mask)
    assert torch.equal(wrapped, plain)


def test_prefill_attention_on_the_cpu_is_dense_attention():
    """On the CPU a cache prefill's attention is the plain
    dense_attention, bit for bit, at any offset."""
    for offset in (0, 131):
        q, k, v, valid = (torch.from_numpy(t) for t in _cache_block(
            3, offset, 8, 2))
        assert torch.equal(
            fa.prefill_attention(q, k, v, offset, valid),
            dense_attention(q, k, v, causal=True, q_offset=offset,
                            kv_offset=0, kv_segment_valid=valid))


def test_prefill_attention_off_the_cpu_is_one_flash_launch(monkeypatch):
    """Off the CPU a cache prefill's attention is one causal
    flash_attention call for the whole block at its offset, with the
    validity row: nothing else runs, so a block the kernel refuses
    raises."""
    seen = []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: seen.append((a, kw)) or a[0])
    q = torch.empty(2, 40, 8, 16, device="meta")
    kv = torch.empty(2, 96, 2, 16, device="meta")
    valid = torch.empty(2, 96, dtype=torch.bool, device="meta")
    assert fa.prefill_attention(q, kv, kv, 37, valid) is q
    (args, kw), = seen
    assert args == (q, kv, kv)
    assert kw == {"causal": True, "q_offset": 37, "kv_segment_valid": valid}


@pytest.mark.parametrize("bad,match", [
    (dict(causal=True, q_offset=-1), "within Lk"),
    (dict(causal=True, q_offset=57), "within Lk"),
    (dict(causal=False, q_offset=20), "without causal"),
    (dict(causal=True, q_offset=1.5), "integer")])
def test_wrapper_raises_on_a_bad_offset(bad, match):
    """An offset must place the block inside the keys (40 queries over
    96 keys: at most 56), and only a causal call takes one."""
    q, k, v, _ = (torch.from_numpy(t) for t in _cache_block(5, 32, 4, 2))
    assert k.shape[1] == 96
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v, **bad)
    fa.flash_attention(q, k, v, causal=True, q_offset=56)


def test_autograd_function_passes_the_offset_through(monkeypatch):
    """The card's autograd.Function at an offset, the kernel swapped for
    the plain version: the forward and its recomputed backward both take
    the block's offset."""
    monkeypatch.setattr(fa, "_launch",
                        lambda q, k, v, causal, scale, mask, q_offset:
                        fa.flash_attention_reference(
                            q, k, v, causal=causal, scale=scale,
                            kv_segment_valid=mask, q_offset=q_offset))
    q, k, v, valid = (torch.from_numpy(t) for t in _cache_block(9, 20, 4, 2))
    mask = valid.int()
    grads = []
    for fn in (lambda *t: fa._FlashAttention.apply(*t, True, 0.25, mask, 20),
               lambda *t: fa.flash_attention_reference(
                   *t, causal=True, scale=0.25, kv_segment_valid=mask,
                   q_offset=20)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# The kernel's launch plan, mirrored in Python (the library's
# kft_flash_attention_smem_bytes holds it to the .cu on the card).

INSTANTIATIONS = [(dtype, d) for dtype, dims in fa.HEAD_DIMS.items()
                  for d in dims]


@pytest.mark.parametrize("dtype,d", INSTANTIATIONS)
def test_every_instantiated_plan_fits_a_block(dtype, d):
    plan = fa.launch_plan(dtype, d, 2048)
    assert fa.MAX_SMEM_BYTES == 232448
    assert 0 < plan.smem_bytes <= fa.MAX_SMEM_BYTES
    if dtype == torch.bfloat16:
        assert (plan.route, plan.threads, plan.block_q) == ("wgmma", 384, 128)
        assert plan.block_k == (128 if d <= 128 else 64)
    else:
        assert (plan.route, plan.threads, plan.block_q) == ("fma", 128, 64)


def test_llama_plan_is_one_block_per_sm():
    # Q 32 KB + two stages of K and V at 32 KB each, bitmasks, nine
    # mbarriers and 1 KB of alignment: more than half of an SM's 227 KB.
    plan = fa.launch_plan(torch.bfloat16, 128, 2048, batch_heads=64)
    assert plan.smem_bytes == 164968
    assert plan.grid == (64, 16)
    assert 2 * plan.smem_bytes > fa.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lq", [1, 100, 1000, 2048])
def test_grid_covers_ragged_lq(dtype, lq):
    plan = fa.launch_plan(dtype, 64, lq, batch_heads=6)
    batch_heads, q_tiles = plan.grid
    assert batch_heads == 6
    assert (q_tiles - 1) * plan.block_q < lq <= q_tiles * plan.block_q


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_accepted_head_dims_are_the_instantiations(dtype):
    accepted = set()
    for d in range(1, 513):
        try:
            fa.launch_plan(dtype, d, 128)
        except ValueError:
            continue
        accepted.add(d)
    assert accepted == set(fa.HEAD_DIMS[dtype])
    if dtype == torch.bfloat16:
        assert accepted == {16, 32, 64, 128, 256}


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 48), (torch.bfloat16, 96), (torch.bfloat16, 512),
    (torch.float32, 8), (torch.float32, 144), (torch.float16, 64)])
def test_wrapper_raises_where_no_kernel_is_instantiated(dtype, d):
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    with pytest.raises(ValueError, match="head_dim|dtypes"):
        fa._check_inputs(q, q, q, None)
    with pytest.raises(ValueError):
        fa.launch_plan(dtype, d, 8)


def test_every_registered_model_head_dim_has_a_kernel():
    # Each registered attention model's cache-free forward reaches the
    # kernel at its default dtype (llama-test: head_dim 16 in bf16).
    from kubeflow_tpu_torch.models import registry

    registry._ensure_loaded()
    seen = {}
    for name, entry in registry._MODELS.items():
        model = entry.make()
        if hasattr(model, "head_dim"):
            seen[name] = (model.dtype, model.head_dim)
            fa.launch_plan(model.dtype, model.head_dim, 2048)
    assert seen["llama-test"] == (torch.bfloat16, 16)
    assert seen["llama3-8b"] == (torch.bfloat16, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lq,lk,offset", [
    (200, 800, 448), (200, 648, 448), (64, 544, 448), (129, 400, 37),
    (2048, 2048, 0), (1, 544, 300)])
def test_plan_kv_tiles_at_an_offset(dtype, lq, lk, offset):
    """The kv tiles each q tile runs: under causality every tile that
    holds a key at or before the tile's last query's position (offset +
    its last row), whatever the block's width; without it every tile."""
    plan = fa.launch_plan(dtype, 128 if dtype == torch.bfloat16 else 64,
                          lq, lk=lk, causal=True, q_offset=offset)
    bq, bk = plan.block_q, plan.block_k
    assert len(plan.kv_tiles) == plan.grid[1]
    for i, tiles in enumerate(plan.kv_tiles):
        last = offset + min(lq, (i + 1) * bq) - 1
        assert tiles == sum(1 for t in range(-(-lk // bk)) if t * bk <= last)
    free = fa.launch_plan(dtype, 64, lq, lk=lk)
    assert set(free.kv_tiles) == {-(-lk // free.block_k)}
    assert fa.launch_plan(dtype, 64, lq).kv_tiles == ()


def test_plan_kv_tiles_at_offset_0_are_the_blocks_own():
    """At offset 0 a causal q tile runs the kv tiles up to its own last
    row (capped at Lq), as before offsets: predict and classify do not
    change."""
    plan = fa.launch_plan(torch.bfloat16, 128, 2048, lk=2048, causal=True)
    assert plan.kv_tiles == tuple(range(1, 17))
    plan = fa.launch_plan(torch.float32, 64, 100, lk=100, causal=True)
    assert plan.kv_tiles == (1, 2)
    # A chunk of 64 at 448 over 544 slots: its last query sits at 511,
    # the last key of the fourth 128-key tile; the fifth is never read.
    plan = fa.launch_plan(torch.bfloat16, 128, 64, lk=544, causal=True,
                          q_offset=448)
    assert plan.kv_tiles == (4,)
