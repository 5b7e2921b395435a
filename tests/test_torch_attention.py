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

"""kubeflow_tpu_torch.ops.attention vs kubeflow_tpu.ops.attention.

The same numpy-seeded fp32 inputs go through both. Tolerance 2e-5, the
reference's own attention-forward tolerance: both sides keep fp32
statistics and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jax_attn
from kubeflow_tpu_torch.ops import attention as torch_attn

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b=2, lq=32, lk=32, h=4, hkv=4, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, lk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, lk, hkv, d), dtype=np.float32)
    return q, k, v


def _both(fn_jax, fn_torch, arrays, **kw):
    ref = fn_jax(*(jnp.asarray(a) for a in arrays), **kw)
    out = fn_torch(*(torch.from_numpy(a) for a in arrays),
                   **{k: torch.from_numpy(np.asarray(v))
                      if isinstance(v, np.ndarray) else v
                      for k, v in kw.items()})
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2])
def test_dense_matches_reference(causal, hkv):
    q, k, v = _qkv(0, hkv=hkv)
    ref, out = _both(jax_attn.dense_attention, torch_attn.dense_attention,
                     (q, k, v), causal=causal)
    np.testing.assert_allclose(out, ref, **TOL)


def test_dense_offsets():
    # A query shard at positions 16.. against keys 8..: the ring-step
    # form of the causal mask.
    q, k, v = _qkv(1, lq=8, lk=24)
    ref, out = _both(jax_attn.dense_attention, torch_attn.dense_attention,
                     (q, k, v), causal=True, q_offset=16, kv_offset=8)
    np.testing.assert_allclose(out, ref, **TOL)


def test_dense_key_mask_2d_and_fully_masked_row():
    q, k, v = _qkv(2, lq=8, lk=8)
    mask = np.ones((2, 8), np.int32)
    mask[0, 5:] = 0
    mask[1, :] = 0  # every key of row 1 masked → output 0
    ref, out = _both(jax_attn.dense_attention, torch_attn.dense_attention,
                     (q, k, v), kv_segment_valid=mask)
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[1] == 0)


def test_dense_key_mask_3d_per_query():
    q, k, v = _qkv(3, lq=4, lk=12)
    rng = np.random.default_rng(4)
    mask = (rng.random((2, 4, 12)) < 0.6).astype(np.int32)
    mask[:, :, 0] = 1
    ref, out = _both(jax_attn.dense_attention, torch_attn.dense_attention,
                     (q, k, v), kv_segment_valid=mask)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("lk,block", [(64, 16), (48, 32), (37, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_matches_reference(lk, block, causal):
    # 48 % 32 → the largest-divisor path; 37 is prime → the pad path.
    q, k, v = _qkv(5, lq=lk, lk=lk, hkv=2)
    ref, out = _both(jax_attn.blockwise_attention,
                     torch_attn.blockwise_attention, (q, k, v),
                     block_size=block, causal=causal)
    np.testing.assert_allclose(out, ref, **TOL)


def test_blockwise_prime_length_with_mask():
    q, k, v = _qkv(6, lq=37, lk=37)
    mask = np.ones((2, 37), np.int32)
    mask[1, 30:] = 0
    ref, out = _both(jax_attn.blockwise_attention,
                     torch_attn.blockwise_attention, (q, k, v),
                     block_size=16, kv_segment_valid=mask)
    np.testing.assert_allclose(out, ref, **TOL)


def test_block_update_init_finalize():
    q, k, v = _qkv(7, lq=16, lk=32, hkv=2)
    mask = np.ones((2, 16), np.int32)
    mask[0, 10:] = 0
    jc = jax_attn.attention_init_carry(2, 16, 4, 16)
    tc = torch_attn.attention_init_carry(2, 16, 4, 16)
    for start in (0, 16):
        kw = dict(scale=0.25, q_offset=8, kv_offset=start, causal=True)
        blk = slice(start, start + 16)
        jc = jax_attn.attention_block_update(
            jc, jnp.asarray(q), jnp.asarray(k[:, blk]), jnp.asarray(v[:, blk]),
            kv_segment_valid=jnp.asarray(mask), **kw)
        tc = torch_attn.attention_block_update(
            tc, torch.from_numpy(q), torch.from_numpy(k[:, blk]),
            torch.from_numpy(v[:, blk]),
            kv_segment_valid=torch.from_numpy(mask), **kw)
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    ref = jax_attn.attention_finalize(jc[0], jc[2], jnp.float32)
    out = torch_attn.attention_finalize(tc[0], tc[2], torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_repeat_kv():
    x = np.random.default_rng(8).standard_normal((2, 3, 2, 4)).astype(
        np.float32)
    ref = jax_attn._repeat_kv(jnp.asarray(x), 3)
    out = torch_attn._repeat_kv(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
