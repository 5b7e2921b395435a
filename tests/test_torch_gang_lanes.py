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

"""Every eager engine lane on a 2-rank gloo gang of the port.

The reference writes one ``llama-test`` fp32 weight set as a ``tensor=2``
sharded export and as a monolithic one, on the metadata of
``tests/test_serving_sharded.py`` (8-token prompts, 6 new tokens, a
32-position cache), as ``tests/test_torch_tensor_serving.py`` does. The
gang loads the sharded export (each rank its own shard) and runs, greedy
and sampled (temperature 0.8, explicit keys), the plain lane, the prefix
lane (4-token pages), chunked prefill (4-token chunks), the host KV tier
(a 9-page pool that spills) and speculative decoding (the monolithic
export as a whole draft on every rank), rank 0 driving each lane's
engine while rank 1 follows. Held, bitwise: prefix hits equal their cold
runs and the B = 1 run; spec equals vanilla; chunked equals one-shot;
host-tier re-adoption and a fleet import equal the cold run; resumes at
1, the middle and budget - 1 equal the uninterrupted stream; a handoff
from the gang adopted by a one-process engine of the monolithic export,
and one from that engine adopted by the gang, equal both sides' local
runs, in both cache layouts; rank 1's tokens equal rank 0's, every lap
held to rank 0's pool digest; the gang's tokens equal the reference's
one-device engine's.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_gang import run_gang
from kubeflow_tpu.models.llama import llama_test
from kubeflow_tpu.serving import sharding as sh
from kubeflow_tpu.serving.export import export_model
from kubeflow_tpu.serving.model import load_version as jax_load_version
from kubeflow_tpu.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)
from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.model import LoadedModel, load_version

PROMPT_LEN = 8
NEW_TOKENS = 6
CACHE = 32
MODES = {"greedy": {"temperature": 0.0}, "sampled": {"temperature": 0.8}}
PREFIX = {"engine_prefix_cache": True, "engine_page_size": 4}
LANES = {
    "plain": {},
    "prefix": PREFIX,
    "chunk": dict(PREFIX, engine_prefill_chunk=4),
    "tier": dict(PREFIX, engine_slots=1, engine_num_pages=9,
                 engine_host_cache_bytes=1 << 20),
    "spec": {"engine_draft_tokens": 2},
}
#: Resume points: 1, the middle, budget - 1.
CUTS = (1, NEW_TOKENS // 2, NEW_TOKENS - 1)


def _metadata(temperature):
    return ModelMetadata(
        model_name="sharded", registry_name="llama-test",
        model_kwargs={"dtype": "float32", "cache_size": CACHE},
        signatures={"serving_default": Signature(
            "generate",
            {"input_ids": TensorSpec("int32", (-1, PROMPT_LEN))},
            {"tokens": TensorSpec("int32", (-1, NEW_TOKENS))})},
        generate_config={"max_new_tokens": NEW_TOKENS,
                         "temperature": temperature, "seed": 5,
                         "deterministic": True,
                         "engine_slots": 2, "engine_page_size": 8,
                         "engine_slice_tokens": 2})


def _variant(loaded, sampling, knobs):
    meta = loaded.metadata
    return LoadedModel(
        metadata=dataclasses.replace(meta, generate_config=dict(
            meta.generate_config, **sampling, **knobs)),
        version=loaded.version, params=loaded.params, max_batch=4,
        device="cpu")


def _key(i):
    return np.asarray(jax.random.PRNGKey(100 + i), np.uint32)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    base = tmp_path_factory.mktemp("gang-lanes")
    model = llama_test(dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, PROMPT_LEN), jnp.int32))
    params = {"params": variables["params"]}
    meta = _metadata(0.8)
    export_model(str(base / "mono"), 1, meta, params)
    export_model(str(base / "mono-greedy"), 1, _metadata(0.0), params)
    sh.export_model_sharded(str(base / "sharded"), 1, meta, params,
                            sh.ShardSpec(tensor=2))
    mono = str(base / "mono" / "1")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (8, 5, 8, 3)]
    x = prompts[0]
    y = np.concatenate([x[:6], rng.integers(0, 512, (2,))]).astype(np.int32)
    tier = [rng.integers(0, 512, (8,)).astype(np.int32) for _ in range(5)]
    lanes = dict(LANES, spec=dict(LANES["spec"], engine_draft_export=mono))
    case = {"name": "lanes", "export": str(base / "sharded" / "1"),
            "modes": MODES, "lanes": lanes, "prompts": prompts,
            "keys": [_key(i) for i in range(len(prompts))], "cuts": CUTS,
            "prefix_prompts": [x, y, x],
            "prefix_keys": [_key(0), _key(10), _key(0)],
            "tier_prompts": tier + [tier[0]],
            "tier_keys": [_key(20 + i) for i in range(5)] + [_key(20)],
            "handoff_prompt": prompts[1], "handoff_key": _key(30)}
    # The one-process side: the port's engine over the monolithic export.
    one = load_version(mono, max_batch=4, device="cpu")
    local, incoming, blocks = {}, {}, {}
    for mode, sampling in MODES.items():
        for lane in ("plain", "prefix"):
            engine = _variant(one, sampling, LANES[lane]).ensure_engine()
            p, k = case["handoff_prompt"], case["handoff_key"]
            local[mode, lane] = engine.submit(p, rng=k).result(120.0)
            incoming[mode, lane] = wire.encode_kv_handoff(
                "sharded", 1, engine.run_prefill(p, rng=k))
            if lane == "prefix":
                engine.submit(x, rng=_key(0)).result(120.0)
                blocks[mode] = wire.encode_kv_blocks(
                    "sharded", 1, 4, engine.export_prefix_blocks(x))
            engine.stop()
    case["incoming"] = incoming
    case["incoming_blocks"] = blocks
    # The gang runs (in a thread: it waits on its processes) while this
    # process runs the reference's one-device engine on the same requests.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_gang, "lanes", [case], base / "gang",
                            world=2)
        reference = {}
        for mode, path in (("sampled", mono),
                           ("greedy", str(base / "mono-greedy" / "1"))):
            ref = jax_load_version(path, max_batch=4)
            engine = ref.ensure_engine()
            streams = [engine.submit(p, rng=k)
                       for p, k in zip(prompts, case["keys"])]
            reference[mode] = [s.result(120.0) for s in streams]
            ref.close()
        ranks = ranks.result()
    return {"case": case, "ranks": [r["lanes"] for r in ranks],
            "one": one, "local": local, "reference": reference}


def test_each_rank_read_its_own_shard(gang):
    for r, res in enumerate(gang["ranks"]):
        assert res["opened"] == [f"params.shard-0000{r}-of-00002.msgpack"]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lane", sorted(LANES))
def test_ranks_agree_lap_by_lap(gang, mode, lane):
    lead, follower = (r[mode, lane] for r in gang["ranks"])
    assert follower["engine"] == lead["engine"]
    assert lead["engine"]
    # Every lap of rank 1 held its pool to rank 0's digest first.
    assert follower["laps"] == lead["laps"] > 0
    assert lead["stats"]["gang"] == {"ranks": 2, "capture_graphs": False}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_lane_is_b1_and_resumes_are_uninterrupted(gang, mode):
    got = gang["ranks"][0][mode, "plain"]
    for i, (stream, b1) in enumerate(zip(got["streams"], got["b1"])):
        np.testing.assert_array_equal(stream, b1, err_msg=f"request {i}")
    full = got["streams"][0]
    for cut, resumed in zip(CUTS, got["resumes"]):
        np.testing.assert_array_equal(resumed, full[cut:],
                                      err_msg=f"resume at {cut}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_equals_vanilla(gang, mode):
    ranks = gang["ranks"][0]
    spec, plain = ranks[mode, "spec"], ranks[mode, "plain"]
    for i, (a, b) in enumerate(zip(spec["streams"], plain["streams"])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert spec["stats"]["spec"]["rounds"] > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefix_hits_and_chunks_equal_their_cold_runs(gang, mode):
    ranks = gang["ranks"][0]
    prefix, chunk = ranks[mode, "prefix"], ranks[mode, "chunk"]
    for i, (warm, cold) in enumerate(zip(prefix["warm"], prefix["cold"])):
        np.testing.assert_array_equal(warm, cold, err_msg=f"hit {i}")
    assert prefix["stats"]["prefix_cache"]["hits"] >= 2
    # The full-width prompt's cold run is its B = 1 run.
    np.testing.assert_array_equal(prefix["cold"][0],
                                  ranks[mode, "plain"]["b1"][0])
    for what in ("cold", "warm"):
        for i, (a, b) in enumerate(zip(chunk[what], prefix[what])):
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"chunked {what} {i}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_tier_readoption_and_fleet_import(gang, mode):
    ranks = gang["ranks"][0]
    tier = ranks[mode, "tier"]
    np.testing.assert_array_equal(tier["streams"][-1], tier["streams"][0])
    host = tier["stats"]["kv_tier"]["host"]
    assert host["spilled_blocks"] > 0 and host["readopted_blocks"] > 0, host
    assert tier["imported"] > 0
    np.testing.assert_array_equal(tier["imported_stream"],
                                  ranks[mode, "prefix"]["cold"][0])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("lane", ("plain", "prefix"))
def test_handoff_crosses_between_gang_and_one_process(gang, mode, lane):
    got = gang["ranks"][0][mode, lane]
    local = gang["local"][mode, lane]
    np.testing.assert_array_equal(got["local"], local)
    np.testing.assert_array_equal(got["adopted"], local)
    carried = wire.decode_kv_handoff(got["blob"], model="sharded",
                                     version=1)
    assert carried.layout == ("right" if lane == "prefix" else "left")
    engine = _variant(gang["one"], MODES[mode],
                      LANES[lane]).ensure_engine()
    try:
        np.testing.assert_array_equal(
            engine.submit(handoff=carried).result(120.0), local)
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gang_blocks_import_into_one_process(gang, mode):
    blocks = wire.decode_kv_blocks(
        gang["ranks"][0][mode, "prefix"]["blocks"], model="sharded",
        version=1, page_size=4)
    engine = _variant(gang["one"], MODES[mode],
                      LANES["tier"]).ensure_engine()
    try:
        assert engine.import_prefix_blocks(blocks) == len(blocks) > 0
        case = gang["case"]
        np.testing.assert_array_equal(
            engine.submit(case["prefix_prompts"][0],
                          rng=case["prefix_keys"][0]).result(120.0),
            gang["ranks"][0][mode, "prefix"]["cold"][0])
        assert engine.stats()["prefix_cache"]["hits"] == 1
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gang_tokens_equal_the_reference_one_device_engine(gang, mode):
    got = gang["ranks"][0][mode, "plain"]["streams"]
    for i, want in enumerate(gang["reference"][mode]):
        np.testing.assert_array_equal(got[i], want, err_msg=f"request {i}")


def test_a_follower_whose_pool_drifts_raises():
    """The guard: a follower lap whose pool differs from rank 0's digest
    raises before any device work."""
    model = get_model("llama-test").make(dtype="float32", cache_size=CACHE)
    params = convert.init_params(model, seed=0, device="cpu")
    engine = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=NEW_TOKENS, max_prompt_len=PROMPT_LEN, num_slots=2,
        page_size=8), device="cpu")
    try:
        engine.follow_lap([], [], digest=engine.pool_digest())
        drifted = list(engine.pool_digest())
        drifted[0] -= 1
        with pytest.raises(RuntimeError, match="drifted apart"):
            engine.follow_lap([], [], digest=tuple(drifted))
    finally:
        engine.stop()
