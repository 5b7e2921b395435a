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

"""kubeflow_tpu_torch's CUDA kernels on the card, against their plain
versions. Every test here needs a GPU and skips without one.

The file imports neither JAX nor the reference, so it runs on a machine
with PyTorch and CUDA alone; tests/conftest.py imports JAX, so skip it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import pytest
import torch

from kubeflow_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

#: bf16 outputs round to 8 mantissa bits (outputs are averages of
#: N(0, 1) values, below 1); fp32 differs only in summation order.
TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    return torch.device("cuda")


def _qkv(cuda, b, lq, lk, h, hkv, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(
        torch.randn(b, l, n, d, device=cuda, generator=gen).to(dtype)
        for l, n in ((lq, h), (lk, hkv), (lk, hkv)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,masked", [
    (2, 200, 200, 8, 2, 64, True, False),    # ragged tail, GQA 4:1
    (1, 128, 128, 4, 4, 128, True, False),   # whole tiles, MHA
    (2, 96, 160, 4, 1, 64, False, True),     # Lq != Lk, key mask, MQA
    (2, 160, 96, 4, 2, 32, True, True),      # causal + mask, Lq > Lk
    (1, 1, 70, 4, 2, 64, False, False),      # one query row
])
def test_kernel_matches_plain_version(cuda, dtype, b, lq, lk, h, hkv, d,
                                      causal, masked):
    q, k, v = _qkv(cuda, b, lq, lk, h, hkv, d, dtype)
    mask = None
    if masked:
        lengths = torch.tensor([[lk // 2], [lk]], device=cuda)[:b]
        mask = (torch.arange(lk, device=cuda)[None, :] < lengths).to(
            torch.int32)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, kv_segment_valid=mask)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = fa.flash_attention_reference(q, k, v, causal=causal,
                                       kv_segment_valid=mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_fully_masked_row_gives_zero(cuda):
    q, k, v = _qkv(cuda, 2, 64, 64, 4, 4, 64, torch.bfloat16)
    mask = torch.ones((2, 64), dtype=torch.int32, device=cuda)
    mask[1] = 0
    out = fa.flash_attention(q, k, v, kv_segment_valid=mask)
    assert torch.all(out[1] == 0)
    assert torch.isfinite(out).all()


def test_strided_views_are_read_in_place(cuda):
    # q/k/v as slices of one fused [B, L, H + 2 Hkv, D] projection: the
    # kernel reads them through their strides, no copy.
    fused = torch.randn(2, 100, 8 + 2 * 2, 64, device=cuda).bfloat16()
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("bad", ["float16", "head_dim_8", "head_dim_512",
                                 "last_dim_strided", "heads", "mask_shape"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    q, k, v = _qkv(cuda, 1, 32, 32, 4, 2, 64, torch.bfloat16)
    mask = None
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim_8":
        q, k, v = (t[..., :8] for t in (q, k, v))
    elif bad == "head_dim_512":
        q, k, v = (t.repeat(1, 1, 1, 8) for t in (q, k, v))
    elif bad == "last_dim_strided":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    elif bad == "heads":
        k, v = k[:, :, :1].expand(1, 32, 3, 64), v[:, :, :1].expand(
            1, 32, 3, 64)
    elif bad == "mask_shape":
        mask = torch.ones((1, 31), dtype=torch.int32, device=cuda)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, kv_segment_valid=mask)
    assert fa.flash_attention.launches == before
