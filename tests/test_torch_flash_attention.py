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


def _compare(q, k, v, mask=None, *, causal=False, block_q=32, block_k=32):
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=block_q, block_k=block_k,
                    kv_segment_valid=None if mask is None
                    else jnp.asarray(mask), interpret=True)
    out = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
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

