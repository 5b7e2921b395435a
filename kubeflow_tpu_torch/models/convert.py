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

"""Model weights for the port: carried across from Flax, or drawn.

Dtypes. Flax keeps every param in fp32 and casts it to the module's
``dtype`` at the op (``nn.Dense(dtype=bf16)`` multiplies by
``kernel.astype(bf16)``). For serving, the port stores each Llama
weight in the dtype its op consumes instead: bf16 everywhere for a bf16
model, except ``lm_head``, which the reference runs in fp32. The
arithmetic is the same — the cast happens once, here, instead of at
every op — and the weights take half the memory. BERT, ViT and the
CNNs keep fp32 master params, as Flax does, and cast at each op
(models/layers.py). A param takes the dtype of the module's template.

Names. Flax's flat ``"/"``-keyed tree maps onto the port's parameter
names one to one::

    tok_embed/embedding                 tok_embed.weight
    layer_{i}/attention/q_proj/kernel   layers.{i}.attention.q_proj.weight
    layer_{i}/attn_norm/scale           layers.{i}.attn_norm.scale
    final_norm/scale                    final_norm.scale
    lm_head/kernel                      lm_head.weight
    conv_init/kernel                    conv_init.weight
    stage{s}_block{b}/conv1/kernel      stage{s}_block{b}.conv1.weight
    stage{s}_block{b}/bn1/scale         stage{s}_block{b}.bn1.scale
    head/kernel, head/bias              head.weight, head.bias
    tok_embed/embedding (BERT)          tok_embed.embedding
    layer_{i}/attention/query/kernel    layers.{i}.attention.query.weight
    layer_{i}/ln_attn/{scale,bias}      layers.{i}.ln_attn.{scale,bias}
    layer_{i}/moe/router/kernel         layers.{i}.moe.router.weight
    layer_{i}/moe/w_in, .../w_out       layers.{i}.moe.w_in, ....w_out
    mlm_bias, pos_embed                 mlm_bias, pos_embed
    mixed5b/b1x1/conv/kernel            mixed5b.b1x1.conv.weight

and the ``batch_stats`` collection (``bn_init/mean``, ``…/bn1/var``)
onto the BN modules' buffers of the same path. Kernels change layout:
a Dense kernel is ``[in, out]`` in Flax and ``[out, in]`` in
``nn.Linear``; a conv kernel is HWIO in Flax and OIHW in PyTorch. Every
other leaf keeps its layout (an embedding table, the MoE experts' ``[E,
d, f]`` and ``[E, f, d]``, a position table).

LoRA adapters (``lora_rank > 0``) live in the reference's separate
``"lora"`` collection, ``layer_{i}/attention/{q,k,v,o}_proj/lora_a``
``[in, r]`` and ``…/lora_b`` ``[r, out]``; the port keeps that layout
under ``layers.{i}.attention.q_proj.lora_a``, so they carry across
untransposed (:func:`lora_from_flax`, :func:`lora_to_flax`).

Training state. :func:`state_to_flax` flattens a train state (the
trainers' ``LMState`` and ``LoRAState``, or any nest of dicts, tuples
and named tuples of tensors and ints) to the flat ``"/"``-keyed dict
the reference's checkpoints hold: the reference's tree paths
(``step``, ``params/layer_0/attention/q_proj/kernel``,
``opt_state/0/mu/...`` — a chain's members by index, a named tuple's
fields by name, optax's), Flax's layouts and dtypes, ints as int32.
:func:`state_from_flax` is its inverse onto a live state of the same
structure.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from kubeflow_tpu_torch.models.llama import LayerCache
from kubeflow_tpu_torch.ops.lora import is_lora_name
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device


def _flax_key(name: str) -> str:
    """The Flax flat key of a port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    if parts[-1] == "weight":
        parts[-1] = "embedding" if parts[0] == "tok_embed" else "kernel"
    return "/".join(parts)


def _kernel_to_torch(key: str, arr: np.ndarray) -> np.ndarray:
    """A Flax kernel in PyTorch's layout: Dense ``[in, out]`` →
    ``[out, in]``; conv HWIO → OIHW. Any other rank raises: reversing
    all axes would swap a conv's spatial taps unseen."""
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"{key}: a rank-{arr.ndim} kernel {arr.shape} has no "
                     "PyTorch layout here (2: Dense, 4: conv HWIO)")


def params_from_flax(flat: Mapping[str, np.ndarray], config: nn.Module,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Port params from a flat ``"/"``-keyed dict of Flax params (as
    ``flax.traverse_util.flatten_dict(params, sep="/")`` gives them).
    ``config`` is the port module the params are for (built on the meta
    device); every one of its parameters (its LoRA adapters aside: they
    are :func:`lora_from_flax`'s) must be present, and no other key may
    be."""
    device = resolve_device(device)
    out = {}
    for name, template in config.named_parameters():
        if is_lora_name(name):
            continue
        key = _flax_key(name)
        if key not in flat:
            raise KeyError(f"Flax params have no {key!r} (for {name})")
        leaf = flat[key]
        if isinstance(leaf, torch.Tensor):  # a bf16 leaf of an export
            leaf = leaf.float().numpy()
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        if key.endswith("/kernel"):
            arr = _kernel_to_torch(key, arr)
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


def params_to_flax(params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flax`: a flat ``"/"``-keyed
    dict of fp32 numpy arrays in Flax's layout (kernels back to
    ``[in, out]`` / HWIO), as Flax keeps params. A bf16 weight widens to
    fp32 exactly, so a round trip through an export gives its bits
    back."""
    out = {}
    for name, t in params.items():
        key = _flax_key(name)
        arr = t.detach().float().cpu().numpy()
        if key.endswith("/kernel"):
            arr = (arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0))
        out[key] = np.ascontiguousarray(arr)
    return out


def flatten_tree(tree: Mapping, sep: str = "/") -> Dict[str, object]:
    """A nested dict as a flat dict keyed by ``sep``-joined paths
    (``flax.traverse_util.flatten_dict(tree, sep=sep)``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            for sub, leaf in flatten_tree(v, sep).items():
                out[f"{k}{sep}{sub}"] = leaf
        else:
            out[k] = v
    return out


def unflatten_tree(flat: Mapping[str, object], sep: str = "/") -> Dict:
    """The inverse of :func:`flatten_tree`."""
    out: Dict = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


_CACHE_KEY = re.compile(r"^layer_(\d+)/attention/(k|v|index)$")


def _host_array(t: torch.Tensor):
    """A tensor on the host as flax_msgpack reads arrays back: numpy,
    except bfloat16, which numpy has no type for, as a CPU tensor."""
    t = t.detach().to("cpu")
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor of its own from an array or a tensor (an array read
    from a blob is a read-only view of its bytes)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(a))


def cache_to_flax(cache: List[LayerCache]) -> Dict[str, object]:
    """A KV cache as the reference's flat ``"/"``-keyed cache collection:
    ``layer_{i}/attention/{k,v}`` (``[B, C, heads, dim]``; numpy, a
    bfloat16 cache as CPU tensors) and ``layer_{i}/attention/index``,
    the int32 scalar (a 0-d array) the reference keeps there."""
    out: Dict[str, object] = {}
    for i, layer in enumerate(cache):
        out[f"layer_{i}/attention/k"] = _host_array(layer.k)
        out[f"layer_{i}/attention/v"] = _host_array(layer.v)
        out[f"layer_{i}/attention/index"] = np.asarray(int(layer.index),
                                                       np.int32)
    return out


def cache_from_flax(flat: Mapping[str, object]) -> List[LayerCache]:
    """The inverse of :func:`cache_to_flax`: one :class:`LayerCache` a
    layer, CPU tensors of their own. Every layer from 0 up must carry
    ``k``, ``v`` and ``index``, K and V of one 4-d shape, and no other
    key may be present."""
    layers: Dict[int, Dict[str, object]] = {}
    for key, value in flat.items():
        m = _CACHE_KEY.match(key)
        if m is None:
            raise ValueError(f"cache key {key!r} is not "
                             f"layer_<i>/attention/{{k,v,index}}")
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = value
    if sorted(layers) != list(range(len(layers))) or not layers:
        raise ValueError(f"cache layers {sorted(layers)} are not 0.."
                         f"{len(layers) - 1}")
    out = []
    for i in range(len(layers)):
        parts = layers[i]
        if set(parts) != {"k", "v", "index"}:
            raise ValueError(f"cache layer {i} carries {sorted(parts)}, "
                             f"not index, k and v")
        k, v = (_host_tensor(parts[n]) for n in ("k", "v"))
        if k.ndim != 4 or k.shape != v.shape:
            raise ValueError(f"cache layer {i}: k {tuple(k.shape)} and v "
                             f"{tuple(v.shape)} are not one 4-d shape")
        out.append(LayerCache(k, v, int(np.asarray(parts["index"]))))
    return out


def init_params(config: nn.Module, seed: int = 0,
                device: DeviceLike = None,
                dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """Random params drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``: norm scales are 1, biases 0, every other
    weight N(0, 0.02), as the reference's Llama and BERT initializers. An 8B model is made on
    the card in seconds. Each is drawn in the template's dtype and, given
    ``dtype``, cast to it at once (the reference's LoRA base:
    ``cast_floating`` of the fp32 init, one tensor at a time). LoRA
    adapters are not params (``ops.lora.init_lora``). (The numbers
    differ from ``jax.random``'s; to compare with the reference, carry
    its params across instead.)"""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, template in config.named_parameters():
        if is_lora_name(name):
            continue
        t = torch.empty(template.shape, dtype=template.dtype, device=device)
        if name.endswith(".scale"):
            t.fill_(1.0)
        elif name.endswith("bias"):
            t.zero_()
        else:
            t.normal_(0.0, 0.02, generator=gen)
        out[name] = t if dtype is None else t.to(dtype)
    return out


def lora_from_flax(flat: Mapping[str, np.ndarray], config: nn.Module,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Port adapters from the reference's flat ``"/"``-keyed ``lora``
    collection: every adapter of ``config`` must be present, fp32, in
    the reference's layout, and no other key may be."""
    device = resolve_device(device)
    out = {}
    for name, template in config.named_parameters():
        if not is_lora_name(name):
            continue
        key = _flax_key(name)
        if key not in flat:
            raise KeyError(f"the lora collection has no {key!r} (for {name})")
        arr = np.array(flat[key], dtype=np.float32)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit "
                             f"{name} {tuple(template.shape)}")
        out[name] = torch.from_numpy(arr).to(device)
    extra = set(flat) - {_flax_key(n) for n in out}
    if extra:
        raise ValueError(f"lora leaves the port model has no place for: "
                         f"{sorted(extra)[:5]}")
    return out


def lora_to_flax(lora: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`lora_from_flax`: the flat ``lora``
    collection, fp32 numpy."""
    return {_flax_key(name): t.detach().float().cpu().numpy()
            for name, t in lora.items()}


def _state_children(node: Any):
    """``(path part, child)`` pairs of a state node, or None for a
    leaf: a dataclass's fields (but not those marked ``static``: the
    module template, the optimizer), a named tuple's fields, a tuple's
    indices, a dict's keys (a port parameter name as its Flax path)."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)
                if not f.metadata.get("static")]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    if isinstance(node, Mapping):
        return [(_flax_key(k), v) for k, v in node.items()]
    return None


def _leaf_to_flax(key: str, leaf: Any):
    if isinstance(leaf, bool) or not isinstance(leaf, (int, torch.Tensor,
                                                      np.ndarray)):
        raise TypeError(f"{key}: a {type(leaf).__name__} is no state leaf")
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, np.ndarray):
        return leaf
    # A copy of its own, even of a CPU tensor: the optimizer updates
    # the live one in place while a checkpoint writer may still hold it.
    t = leaf.detach().to("cpu", copy=True)
    if key.endswith("/kernel") and t.ndim in (2, 4):
        t = t.T if t.ndim == 2 else t.permute(2, 3, 1, 0)
    t = t.contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def state_to_flax(state: Any) -> Dict[str, Any]:
    """A train state as the reference's flat checkpoint dict (see the
    module docstring): numpy arrays in Flax's layout, a bfloat16 leaf as
    a CPU tensor (``serving/flax_msgpack.py`` writes it as Flax does),
    ints as 0-d int32 arrays."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        children = _state_children(node)
        if children is None:
            if prefix in out:
                raise ValueError(f"duplicate flat key {prefix!r} in state")
            out[prefix] = _leaf_to_flax(prefix, node)
            return
        for part, child in children:
            walk(child, f"{prefix}/{part}" if prefix else part)

    walk(state, "")
    return out


def _leaf_from_flax(key: str, value: Any, live: Any):
    if isinstance(live, int):
        return int(np.asarray(value))
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu")
    else:
        t = torch.from_numpy(np.array(value))
    if key.endswith("/kernel") and t.ndim in (2, 4):
        t = _as_torch_kernel(t)
    if tuple(t.shape) != tuple(live.shape):
        raise ValueError(f"leaf {key!r}: checkpoint shape {tuple(t.shape)} "
                         f"!= live {tuple(live.shape)}")
    out = t.to(device=live.device, dtype=live.dtype)
    return out.requires_grad_(live.requires_grad) if out.is_leaf else out


def _as_torch_kernel(t: torch.Tensor) -> torch.Tensor:
    return (t.T if t.ndim == 2 else t.permute(3, 2, 0, 1)).contiguous()


def state_from_flax(flat: Mapping[str, Any], state: Any) -> Any:
    """The inverse of :func:`state_to_flax` onto ``state``'s structure:
    a new state (the live one's static fields kept) whose tensors take
    the live leaves' devices, dtypes and ``requires_grad``. Every live
    leaf must be in ``flat`` at the live shape, and no other key may
    be."""
    seen = set()

    def build(node, prefix):
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name),
                              f"{prefix}/{f.name}" if prefix else f.name)
                for f in dataclasses.fields(node)
                if not f.metadata.get("static")})
        children = _state_children(node)
        if children is None:
            if prefix not in flat:
                raise ValueError(f"the checkpoint lacks leaf {prefix!r}; "
                                 "has the state's structure changed?")
            seen.add(prefix)
            return _leaf_from_flax(prefix, flat[prefix], node)
        values = [build(child, f"{prefix}/{part}" if prefix else part)
                  for part, child in children]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*values)
        if isinstance(node, (tuple, list)):
            return type(node)(values)
        return dict(zip(node.keys(), values))

    out = build(state, "")
    extra = set(flat) - seen
    if extra:
        raise ValueError(f"the checkpoint carries unknown leaves "
                         f"{sorted(extra)[:5]}")
    return out


def batch_stats_from_flax(flat: Mapping[str, np.ndarray], config: nn.Module,
                          device: DeviceLike = None
                          ) -> Dict[str, torch.Tensor]:
    """The BN running statistics from a flat ``"/"``-keyed Flax
    ``batch_stats`` dict, keyed by the port's buffer names; every
    buffer of ``config`` must be present, and no other key may be."""
    device = resolve_device(device)
    out = {}
    for name, template in config.named_buffers():
        key = name.replace(".", "/")
        if key not in flat:
            raise KeyError(f"Flax batch_stats have no {key!r} (for {name})")
        arr = np.array(flat[key], dtype=np.float32)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit "
                             f"{name} {tuple(template.shape)}")
        out[name] = torch.from_numpy(arr).to(device)
    extra = set(flat) - {n.replace(".", "/") for n in out}
    if extra:
        raise ValueError(f"Flax batch_stats the port model has no place "
                         f"for: {sorted(extra)[:5]}")
    return out


#: Flax's lecun_normal: a normal truncated at two standard deviations,
#: scaled so the truncated draw has variance 1 / fan_in (this is the
#: standard deviation of the unit normal truncated to [-2, 2]).
_TRUNCATED_STD = 0.87962566103423978


def init_vision(config: nn.Module, seed: int = 0, device: DeviceLike = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Random ``(params, batch_stats)`` for a vision model (ResNet,
    Inception, VGG, AlexNet, ViT), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, by Flax's default
    initializers: lecun-normal (truncated) conv and Dense kernels, zero
    biases, norm scales 1 (0 where the template says so: each ResNet
    block's ``bn3``), a ViT's position table N(0, 0.02), BN running mean
    0 and var 1 (``batch_stats`` is empty for a model without BN). All
    fp32. (The numbers differ from ``jax.random``'s; to compare with the
    reference, carry its variables across instead.)"""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {}
    for name, template in config.named_parameters():
        t = torch.empty(template.shape, dtype=torch.float32, device=device)
        if name.endswith(".weight"):
            # OIHW or [out, in]: fan_in is everything but dim 0.
            std = (template[0].numel() ** -0.5) / _TRUNCATED_STD
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        elif name.endswith(".scale"):
            module = config.get_submodule(name.rsplit(".", 1)[0])
            t.fill_(getattr(module, "scale_init", 1.0))
        elif name == "pos_embed":
            t.normal_(0.0, 0.02, generator=gen)
        else:  # norm, conv and Dense biases
            t.zero_()
        params[name] = t
    batch_stats = {
        name: (torch.zeros if name.endswith(".mean") else torch.ones)(
            template.shape, dtype=torch.float32, device=device)
        for name, template in config.named_buffers()}
    return params, batch_stats
