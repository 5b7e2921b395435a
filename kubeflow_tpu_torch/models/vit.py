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

"""Vision Transformer (ViT) family in PyTorch.

Port of ``kubeflow_tpu/models/vit.py``: a stride-p patch conv (one
product of ``[B·(H/p)·(W/p), p²·C] × [p²·C, D]``), a learned position
table, pre-LN blocks (x + MHA(LN(x)); x + MLP(LN(x))), a final
LayerNorm, the mean over tokens (no CLS token) and an fp32 head. Params
are fp32 masters cast to the model dtype at each op (models/layers.py);
attention is :func:`~kubeflow_tpu_torch.ops.flash_attention.
flash_attention`, non-causal and unmasked (on the card the kernel, at
224²/p16's 196 tokens a 128-row q tile and a 68-row tail). No dropout
and no BN: ``train`` changes nothing, and the model has no
``batch_stats``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from kubeflow_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    gelu,
    nhwc_input,
)
from kubeflow_tpu_torch.models.registry import ModelEntry, register_model
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.utils.device import torch_dtype

AttentionFn = Callable[..., torch.Tensor]


class ViTBlock(nn.Module):
    """Pre-LN transformer block; its q/k/v/out Dense layers sit on the
    block itself, as in the reference's tree."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, attention_fn=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.ln_attn = LayerNorm(d_model, dtype, device=device)
        self.query = Dense(d_model, d_model, dtype, device=device)
        self.key = Dense(d_model, d_model, dtype, device=device)
        self.value = Dense(d_model, d_model, dtype, device=device)
        self.out = Dense(d_model, d_model, dtype, device=device)
        self.ln_mlp = LayerNorm(d_model, dtype, device=device)
        self.mlp_in = Dense(d_model, mlp_dim, dtype, device=device)
        self.mlp_out = Dense(mlp_dim, d_model, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape

        def split(t):
            return t.reshape(b, l, self.num_heads, d // self.num_heads)

        h = self.ln_attn(x)
        attn = self.attention_fn or flash_attention
        out = attn(split(self.query(h)), split(self.key(h)),
                   split(self.value(h)))
        x = x + self.out(out.reshape(b, l, d))
        h = self.mlp_out(gelu(self.mlp_in(self.ln_mlp(x))))
        return x + h


class ViT(nn.Module):
    """``forward(images, train=True)`` → fp32 logits ``[B, num_classes]``.
    Images are NHWC with H and W divisible by ``patch``. ``image_size``
    sizes the position table (``(image_size / patch)²`` tokens). Built
    on the meta device unless ``device`` is given."""

    #: ``image_size`` sizes a param (the trainer passes it on).
    SIZED_BY_IMAGE = True

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 num_layers: int = 12, d_model: int = 768,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 dtype="bfloat16", attention_fn: Optional[AttentionFn] = None,
                 image_size: int = 224, in_channels: int = 3,
                 device="meta"):
        super().__init__()
        dtype = torch_dtype(dtype)
        self.num_classes = num_classes
        self.patch = patch
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.dtype = dtype
        tokens = (image_size // patch) ** 2
        self.patch_embed = Conv(in_channels, d_model, (patch, patch),
                                (patch, patch), padding="VALID", bias=True,
                                device=device)
        self.pos_embed = nn.Parameter(torch.empty(
            tokens, d_model, dtype=torch.float32, device=device))
        self.layers = nn.ModuleList(
            ViTBlock(d_model, num_heads, mlp_dim, dtype, attention_fn,
                     device)
            for _ in range(num_layers))
        self.ln_final = LayerNorm(d_model, dtype, device=device)
        self.head = Dense(d_model, num_classes, torch.float32,
                          device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train  # no dropout in the benchmark config
        b, h, w, _ = x.shape
        if h % self.patch or w % self.patch:
            raise ValueError(
                f"image {h}x{w} not divisible by patch {self.patch}")
        tokens = (h // self.patch) * (w // self.patch)
        if tokens != self.pos_embed.shape[0]:
            raise ValueError(
                f"image {h}x{w} gives {tokens} tokens; the position table "
                f"has {self.pos_embed.shape[0]} (image_size)")
        x = self.patch_embed(nhwc_input(x, self.dtype))
        x = x.permute(0, 2, 3, 1).reshape(b, tokens, self.d_model)
        x = x + self.pos_embed.to(self.dtype)[None]
        for layer in self.layers:
            x = layer(x)
        x = self.ln_final(x)
        x = x.float().mean(1).to(self.dtype)  # jnp.mean over tokens
        return self.head(x.float())


def vit_base16(**kw) -> ViT:
    return ViT(**kw)


def vit_large16(**kw) -> ViT:
    kw.setdefault("num_layers", 24)
    return ViT(d_model=1024, num_heads=16, mlp_dim=4096, **kw)


def vit_test(**kw) -> ViT:
    """Tiny config for CI: 8x8 patches over 32x32 → 16 tokens."""
    kw.setdefault("num_classes", 10)
    kw.setdefault("image_size", 32)
    kw.setdefault("num_layers", 2)
    return ViT(patch=8, d_model=64, num_heads=4, mlp_dim=128, **kw)


register_model(ModelEntry("vit-b16", "vision", vit_base16,
                          ((224, 224, 3), "bfloat16"), 1000))
register_model(ModelEntry("vit-l16", "vision", vit_large16,
                          ((224, 224, 3), "bfloat16"), 1000))
register_model(ModelEntry("vit-test", "vision", vit_test,
                          ((32, 32, 3), "bfloat16"), 10))
