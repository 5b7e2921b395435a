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

from kubeflow_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops import flash_attention as fa

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
