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

"""Llama weights for the port: carried across from Flax, or drawn.

Dtypes. Flax keeps every param in fp32 and casts it to the module's
``dtype`` at the op (``nn.Dense(dtype=bf16)`` multiplies by
``kernel.astype(bf16)``). The port stores each weight in the dtype its
op consumes instead: bf16 everywhere for a bf16 model, except
``lm_head``, which the reference runs in fp32. The arithmetic is the
same — the cast happens once, here, instead of at every op — and the
weights take half the memory.

Names. Flax's flat ``"/"``-keyed tree maps onto the port's parameter
names one to one::

    tok_embed/embedding                 tok_embed.weight
    layer_{i}/attention/q_proj/kernel   layers.{i}.attention.q_proj.weight
    layer_{i}/attn_norm/scale           layers.{i}.attn_norm.scale
    layer_{i}/gate_proj/kernel          layers.{i}.gate_proj.weight
    final_norm/scale                    final_norm.scale
    lm_head/kernel                      lm_head.weight

Dense kernels are ``[in, out]`` in Flax and ``[out, in]`` in
``nn.Linear``, so they are transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device


def _flax_key(name: str) -> str:
    """The Flax flat key of a port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    if parts[-1] == "weight":
        parts[-1] = "embedding" if parts[0] == "tok_embed" else "kernel"
    return "/".join(parts)


def params_from_flax(flat: Mapping[str, np.ndarray], config: nn.Module,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Port params from a flat ``"/"``-keyed dict of Flax params (as
    ``flax.traverse_util.flatten_dict(params, sep="/")`` gives them).
    ``config`` is the port module the params are for (built on the meta
    device); every one of its parameters must be present, and no other
    key may be."""
    device = resolve_device(device)
    out = {}
    for name, template in config.named_parameters():
        key = _flax_key(name)
        if key not in flat:
            raise KeyError(f"Flax params have no {key!r} (for {name})")
        arr = np.array(flat[key], dtype=np.float32)  # a writable copy
        if key.endswith("/kernel"):
            arr = arr.T
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit "
                             f"{name} {tuple(template.shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=template.dtype)
    extra = set(flat) - {_flax_key(n) for n in out}
    if extra:
        raise ValueError(f"Flax params the port model has no place for: "
                         f"{sorted(extra)[:5]}")
    return out


def init_params(config: nn.Module, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random params drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``: norm scales are 1, every other weight is
    N(0, 0.02), as the reference's initializers. An 8B model is made on
    the card in seconds. (The numbers differ from ``jax.random``'s; to
    compare with the reference, carry its params across instead.)"""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, template in config.named_parameters():
        t = torch.empty(template.shape, dtype=template.dtype, device=device)
        if name.endswith(".scale"):
            t.fill_(1.0)
        else:
            t.normal_(0.0, 0.02, generator=gen)
        out[name] = t
    return out
