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

"""Captured decode programs: the engine's fixed set of programs as CUDA
graphs.

The reference engine runs a fixed set of jitted XLA programs, one per
(program, shape) key, each compiled on first use (the ``engine_compile``
spans of ``kubeflow_tpu/inference/engine/engine.py``). The port's
counterpart is a CUDA graph per key. A key's first use copies the call's
inputs into static buffers, runs the body once on a side stream (any
lazy setup of a kernel library, a workspace or an attribute, happens
there and not inside the capture; that run's outputs are the call's),
then captures the body into a graph and keeps the graph with its static
inputs and outputs. Every later use copies the call's inputs into the
static buffers and replays: no Python runs between the kernels, and no
kernel wrapper is called. Each call therefore runs the body's kernels on
the card once.

All of an engine's graphs allocate from one memory pool: one engine
thread replays them, never two at once, and the engine reads a replay's
outputs before the next one. A capture or a replay that fails raises;
nothing falls back to running the body eagerly.

State that lives on the host (a Python int a body sets, say) is set by
the warm-up run and never by a replay: a body's caller keeps such state
itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional, Union

import numpy as np
import torch

__all__ = ["GraphCache", "Program"]

InputLike = Union[np.ndarray, torch.Tensor, None]


def _as_tensor(value: InputLike) -> Optional[torch.Tensor]:
    if value is None or isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


class Program:
    """One (program, shape) key: its static inputs, its body and, once
    captured, its graph and static outputs.

    ``body(**inputs)`` returns the key's outputs (tensors, or lists and
    tuples of them). ``inputs`` name host arrays or tensors; each gets a
    static device buffer of its shape and dtype (None stays None: a
    greedy slice reads no keys). :meth:`capture` runs and captures the
    body; calling the program replays it."""

    def __init__(self, body: Callable[..., Any], inputs: Dict[str, InputLike],
                 device: torch.device):
        self.body = body
        self.device = torch.device(device)
        self.inputs: Dict[str, Optional[torch.Tensor]] = {}
        for name, value in inputs.items():
            value = _as_tensor(value)
            self.inputs[name] = None if value is None else torch.empty(
                value.shape, dtype=value.dtype, device=self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.replays = 0

    def load(self, inputs: Dict[str, InputLike]) -> None:
        """Copy a call's inputs into the static buffers (``copy_``, in
        stream order)."""
        if inputs.keys() != self.inputs.keys():
            raise ValueError(f"inputs {sorted(inputs)} are not the "
                             f"program's {sorted(self.inputs)}")
        for name, value in inputs.items():
            static = self.inputs[name]
            value = _as_tensor(value)
            if (value is None) != (static is None):
                raise ValueError(f"input {name!r} is None on one call and "
                                 "not on another: a greedy and a sampled "
                                 "call need two keys")
            if static is not None:
                static.copy_(value)

    def capture(self, inputs: Dict[str, InputLike], pool: Any,
                stream: torch.cuda.Stream) -> Any:
        """The first call: load ``inputs``, run the body once on
        ``stream`` (the warm-up; its outputs are returned), then capture
        it into this program's graph, allocating from ``pool``."""
        self.load(inputs)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = self.body(**self.inputs)
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a caller's host-tier
        # or fleet-block copies) do not break this thread's capture.
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.outputs = self.body(**self.inputs)
        self.graph = graph
        return out

    def __call__(self, inputs: Dict[str, InputLike]) -> Any:
        """A replay of the graph on ``inputs``: the static outputs,
        valid until the next call."""
        if self.graph is None:
            raise RuntimeError("the program was never captured")
        self.load(inputs)
        self.graph.replay()
        self.replays += 1
        return self.outputs


class GraphCache:
    """An engine's captured programs: one :class:`Program` per key, one
    memory pool and one warm-up stream for all of them."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.programs: Dict[Hashable, Program] = {}

    def run(self, key: Hashable, body: Callable[..., Any],
            inputs: Dict[str, InputLike]) -> Any:
        """``body(**inputs)``: a replay of ``key``'s graph or, on the
        key's first use, the warm-up run that precedes its capture.
        ``body`` is read only then: a key names one body at one set of
        shapes."""
        program = self.programs.get(key)
        if program is None:
            program = Program(body, inputs, self.device)
            out = program.capture(inputs, self.pool, self.stream)
            self.programs[key] = program
            return out
        return program(inputs)

    def replays(self) -> int:
        return sum(p.replays for p in self.programs.values())
