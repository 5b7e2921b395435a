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

"""BERT encoder (base/large) with a tied-embedding MLM head, in PyTorch.

Port of ``kubeflow_tpu/models/bert.py``, the default model of the
``tpu-lm`` CLI. Post-LN layers (residual, then LayerNorm), Flax's
LayerNorm (ε = 1e-6, fp32 statistics), gelu (tanh) MLPs, fp32 master
params cast to the model dtype at each op (models/layers.py).

Attention is :func:`~kubeflow_tpu_torch.ops.flash_attention.
flash_attention`, non-causal, with the ``[B, L]`` 0/1 ``valid`` mask as
its key-validity row (the CUDA kernel on the card). ``valid=None`` stays
None: no all-ones mask is carried through the kernel.

The MLM head is the reference's code, not its comment: ``Embed.attend``
promotes the query and the table to the model dtype, so the logits'
product is in that dtype (bf16 for a bf16 model), and the fp32
``mlm_bias`` is added after it, giving fp32 logits.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from kubeflow_tpu_torch.models.layers import Dense, Embed, LayerNorm, gelu
from kubeflow_tpu_torch.models.registry import ModelEntry, register_model
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.utils.device import torch_dtype

AttentionFn = Callable[..., torch.Tensor]


class SelfAttention(nn.Module):
    """q/k/v/out Dense layers with biases around one attention call;
    ``mask`` is passed as the attention's ``kv_segment_valid``."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 attention_fn: Optional[AttentionFn] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.query = Dense(d_model, d_model, dtype, device=device)
        self.key = Dense(d_model, d_model, dtype, device=device)
        self.value = Dense(d_model, d_model, dtype, device=device)
        self.out = Dense(d_model, d_model, dtype, device=device)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        b, l, d = x.shape

        def split(t):
            return t.reshape(b, l, self.num_heads, d // self.num_heads)

        attn = self.attention_fn or flash_attention
        out = attn(split(self.query(x)), split(self.key(x)),
                   split(self.value(x)), kv_segment_valid=mask)
        return self.out(out.reshape(b, l, d))


class BertLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, attention_fn=None, device=None):
        super().__init__()
        self.attention = SelfAttention(d_model, num_heads, dtype,
                                       attention_fn, device)
        self.ln_attn = LayerNorm(d_model, dtype, device=device)
        self.mlp_in = Dense(d_model, mlp_dim, dtype, device=device)
        self.mlp_out = Dense(mlp_dim, d_model, dtype, device=device)
        self.ln_mlp = LayerNorm(d_model, dtype, device=device)

    def forward(self, x: torch.Tensor, valid) -> torch.Tensor:
        x = self.ln_attn(x + self.attention(x, valid))
        h = self.mlp_out(gelu(self.mlp_in(x)))
        return self.ln_mlp(x + h)


class Bert(nn.Module):
    """BERT encoder + MLM head: ``forward(input_ids, type_ids=None,
    valid=None, train=True)`` → fp32 MLM logits ``[B, L, vocab]``.
    ``valid`` is the ``[B, L]`` 0/1 attention mask. Built on the meta
    device unless ``device`` is given."""

    def __init__(self, vocab_size: int = 30522, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 num_segments: int = 2, dtype="bfloat16",
                 attention_fn: Optional[AttentionFn] = None,
                 device="meta"):
        super().__init__()
        dtype = torch_dtype(dtype)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_kv_heads = num_heads
        self.head_dim = d_model // num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.tok_embed = Embed(vocab_size, d_model, dtype, device=device)
        self.pos_embed = Embed(max_len, d_model, dtype, device=device)
        self.seg_embed = Embed(num_segments, d_model, dtype, device=device)
        self.ln_embed = LayerNorm(d_model, dtype, device=device)
        self.layers = nn.ModuleList(
            BertLayer(d_model, num_heads, mlp_dim, dtype, attention_fn,
                      device)
            for _ in range(num_layers))
        self.mlm_transform = Dense(d_model, d_model, dtype, device=device)
        self.mlm_ln = LayerNorm(d_model, dtype, device=device)
        self.mlm_bias = nn.Parameter(torch.empty(
            vocab_size, dtype=torch.float32, device=device))

    def forward(self, input_ids: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                train: bool = True) -> torch.Tensor:
        del train  # no dropout in the pretraining config
        l = input_ids.shape[1]
        if type_ids is None:
            type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(l, device=input_ids.device)[None, :]
        x = self.tok_embed(input_ids)
        x = x + self.pos_embed(positions)
        x = x + self.seg_embed(type_ids)
        x = self.ln_embed(x)
        for layer in self.layers:
            x = layer(x, valid)
        h = self.mlm_ln(gelu(self.mlm_transform(x)))
        return self.tok_embed.attend(h.float()).float() + self.mlm_bias


def bert_base(**kw) -> Bert:
    return Bert(**kw)


def bert_large(**kw) -> Bert:
    kw.setdefault("num_layers", 24)
    return Bert(d_model=1024, num_heads=16, mlp_dim=4096, **kw)


def bert_test(**kw) -> Bert:
    """Tiny config for CI (2 layers, d=64)."""
    kw.setdefault("vocab_size", 512)
    kw.setdefault("max_len", 128)
    kw.setdefault("num_layers", 2)
    return Bert(d_model=64, num_heads=4, mlp_dim=128, **kw)


register_model(ModelEntry("bert-base", "language", bert_base,
                          ((128,), "int32"), 30522))
register_model(ModelEntry("bert-large", "language", bert_large,
                          ((128,), "int32"), 30522))
register_model(ModelEntry("bert-test", "language", bert_test,
                          ((64,), "int32"), 512))
