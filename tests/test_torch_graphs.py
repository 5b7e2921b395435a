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

"""The bodies the engine captures, run over their static buffers on the
CPU.

On the card the engine runs a plain slice, a speculative round's draft
and verify and a classic admission's prefill as CUDA graphs over static
buffers (``inference/engine/graphs.py``). A CPU has no graphs, so these
tests run each captured program's body eagerly over its static buffers
(:class:`Program`'s inputs, loaded by ``Program.load``), which is what
the graph captures. Every such call must give the outputs, and write the
page pool, draft cache and prefill cache, that the uncaptured engine's
call on the same inputs gives and writes, bit for bit, and the streams
must be the uncaptured engine's, in the engine, prefix, spec and chunk
mixes, greedy and sampled, with one program per ``engine_compile`` key
of a captured program. This shows the static-buffer plumbing, not the
capture: what a replay alone could get wrong (a host read, host state
it skips) shows only on the card, where ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold the captured engine to the uncaptured one.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from kubeflow_tpu_torch.inference.engine.graphs import Program
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.models.llama import LayerCache, llama_test

CACHE = 48
#: The engine's captured programs, by engine_compile program name.
CAPTURED = ("decode_slice", "spec_draft", "spec_verify", "prefill")
#: The mixes at llama-test size: the classic lane, the prefix lane, a
#: strong draft (the model itself, k = 2) and the prefix lane chunked at
#: one page with it.
MIXES = {"engine": {}, "prefix": {"prefix_cache": True},
         "spec": {"speculate_tokens": 2},
         "chunk": {"prefix_cache": True, "prefill_chunk": 4,
                   "speculate_tokens": 2}}
PROMPTS = (5, 16, 3, 9, 12, 16)
BUDGETS = (8, 4, 8, 6, 8, 7)


@pytest.fixture(scope="module")
def model():
    return llama_test(dtype="float32", cache_size=CACHE)


@pytest.fixture(scope="module")
def params(model):
    return init_params(model, seed=0, device="cpu")


def _requests(mix):
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 512, (10,)).astype(np.int32)
    out = []
    for i, (n, budget) in enumerate(zip(PROMPTS, BUDGETS)):
        prompt = rng.randint(0, 512, (n,)).astype(np.int32)
        if MIXES[mix].get("prefix_cache"):
            prompt = np.concatenate([shared, prompt])[:16]
        out.append((prompt, budget, prng.PRNGKey(100 + i)))
    return out


def _engine(model, params, mix, temperature, name):
    config = dict(max_new_tokens=8, max_prompt_len=16,
                  temperature=temperature, top_k=40, top_p=0.9,
                  num_slots=4, page_size=4, slice_tokens=4, seed=0)
    config.update(MIXES[mix])
    draft = (dict(draft_model=model, draft_params=params)
             if config.get("speculate_tokens") else {})
    return DecodeEngine(model, params, EngineConfig(**config), name=name,
                        device="cpu", **draft)


def _run(engine, requests):
    streams = [engine.submit(p, rng=k, max_new_tokens=b)
               for p, b, k in requests]
    return [s.result(timeout=120) for s in streams]


def _leaves(tree):
    """The tensors of a program's outputs or of engine state, in order
    (LayerCache K/V included)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, LayerCache):
        return [tree.k, tree.v]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


class CheckedPrograms:
    """The engine's program cache on the CPU (it stands where the
    engine's ``GraphCache`` stands): each key's :class:`Program` holds
    static buffers, and a call loads them and runs the body over them
    eagerly. Before each call the key's body runs on fresh tensors of
    the same inputs (what the uncaptured engine runs: ``_decode_slice``,
    ``_draft_proposals``, ``_verify_slice``, the admission prefill), its
    outputs and the state it wrote (the page pool, the draft cache, the
    prefill cache) are kept, the state is put back, and the static-buffer
    call must give the same bits."""

    def __init__(self, engine):
        self.engine = engine
        self.programs = {}
        self.checked = {}

    def _state(self):
        e = self.engine
        return _leaves([e.kv.physical, e._draft_cache or [],
                        e._prefill_cache or []])

    def run(self, key, body, inputs):
        fresh = {k: None if v is None else torch.as_tensor(
            np.array(v) if isinstance(v, np.ndarray) else v.clone())
            for k, v in inputs.items()}
        before = [t.clone() for t in self._state()]
        want = [t.clone() for t in _leaves(body(**fresh))]
        wrote = [t.clone() for t in self._state()]
        for t, saved in zip(self._state(), before):
            t.copy_(saved)
        program = self.programs.setdefault(
            key, Program(body, inputs, "cpu"))
        program.load(inputs)
        got = program.body(**program.inputs)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got), want))
        assert len(_leaves(got)) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(self._state(), wrote))
        self.checked[key[0]] = self.checked.get(key[0], 0) + 1
        return got


@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_static_buffer_bodies_equal_the_eager_slices(model, params, mix,
                                                     temperature):
    eager = _engine(model, params, mix, temperature, f"g-eager-{mix}")
    programs = _engine(model, params, mix, temperature, f"g-prog-{mix}")
    assert eager._graphs is None and programs._graphs is None
    checked = programs._graphs = CheckedPrograms(programs)
    requests = _requests(mix)
    try:
        want = _run(eager, requests)
        got = _run(programs, requests)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        keys = set(programs._graphs.programs)
        assert keys == {k for k in programs._compile_seen
                        if k[0] in CAPTURED}
        assert programs.captured_keys() == keys
        assert eager.captured_keys() == set()
        names = {k[0] for k in keys}
        assert ("prefill" in names) == (not MIXES[mix].get("prefix_cache"))
        assert ("decode_slice" in names) == (
            not MIXES[mix].get("speculate_tokens"))
        assert set(checked.checked) == names
    finally:
        eager.stop()
        programs.stop()


def test_program_copies_inputs_into_its_static_buffers():
    body = lambda a, b: a * 2 if b is None else a + b  # noqa: E731
    program = Program(body, {"a": np.zeros(3, np.float32), "b": None},
                      "cpu")
    static = program.inputs["a"]
    program.load({"a": np.arange(3, dtype=np.float32), "b": None})
    assert program.inputs["a"] is static
    np.testing.assert_array_equal(static.numpy(), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(
        program.body(**program.inputs).numpy(), [0.0, 2.0, 4.0])
    with pytest.raises(ValueError, match="two keys"):
        program.load({"a": np.ones(3, np.float32),
                      "b": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="not the program's"):
        program.load({"a": np.ones(3, np.float32)})
    # Never captured, it has nothing to replay, and it does not run the
    # body in a graph's place.
    with pytest.raises(RuntimeError, match="never captured"):
        program({"a": np.ones(3, np.float32), "b": None})


def test_a_cpu_engine_runs_eagerly(model, params):
    engine = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=4, max_prompt_len=16), device="cpu",
        capture_graphs=True)
    try:
        assert engine._graphs is None
        assert engine.captured_keys() == set()
    finally:
        engine.stop()
