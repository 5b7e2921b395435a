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

"""A mixed fleet: one JAX replica and one port replica behind the
reference's pooled proxy, all in this process on loopback sockets.

- Greedy and sampled tokens are identical through either replica.
- A role-split prefill → decode runs bitwise both ways across the two
  backends (twin of tests/test_role_routing.py's split acceptance).
- A stream killed mid-flight by the fault seam resumes bitwise on the
  other backend (twin of tests/test_serving_faults.py's resume
  acceptance), greedy and sampled.
- A second death on a port replica resumes bitwise: the port's
  resumed stream mints a token with ``prompt_len``, which the
  reference's decoder reads and both replicas resume from.
"""

import json
import os

import numpy as np
import pytest

from kubeflow_tpu.scaling.endpoints import EndpointPool
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu.serving.http_proxy import make_app as proxy_app
from kubeflow_tpu.serving.manager import ModelManager as JaxManager
from kubeflow_tpu.serving.server import make_app as jax_app
from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.manager import ModelManager
from kubeflow_tpu_torch.serving.server import make_app
from tests._torch_serving import (
    ENGINE,
    GREEDY,
    NEW_TOKENS,
    PROMPT_LEN,
    SAMPLED,
    Served,
    export_generate,
    post,
    stream_events,
    unary_tokens,
)

MODELS = {"g": GREEDY, "m": SAMPLED}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    bases = {name: export_generate(root / name, {**cfg, **ENGINE})
             for name, cfg in MODELS.items()}
    previous = os.environ.get("KFT_ENABLE_FAULTS")
    os.environ["KFT_ENABLE_FAULTS"] = "1"
    plans, managers, servers = {}, {}, {}
    for backend, (manager_cls, app, kw) in {
            "jax": (JaxManager, jax_app, {}),
            "port": (ModelManager, make_app, {"device": "cpu"})}.items():
        plans[backend] = root / f"plan_{backend}.json"
        plans[backend].write_text(json.dumps({"rules": []}))
        mgr = manager_cls(poll_interval_s=3600, **kw)
        for name, base in bases.items():
            mgr.add_model(name, str(base), max_batch=2,
                          continuous_batching=True)
        managers[backend] = mgr
        servers[backend] = Served(
            lambda m=mgr, a=app, p=plans[backend]: a(
                m, fault_plan=str(p), sse_keepalive_s=0.5))

    def pool(roles):
        pool = EndpointPool()
        for backend, role in roles:
            pool.add(servers[backend].address, None, role)
        return pool

    proxies = {
        "rr": Served(lambda: proxy_app(
            pool=pool([("jax", "any"), ("port", "any")]),
            balancer="round_robin", probe_interval_s=3600.0,
            stream_stall_timeout_s=1.5, brownout=False)),
        "jax_to_port": Served(lambda: proxy_app(
            pool=pool([("jax", "prefill"), ("port", "decode")]),
            balancer="role", probe_interval_s=3600.0)),
        "port_to_jax": Served(lambda: proxy_app(
            pool=pool([("port", "prefill"), ("jax", "decode")]),
            balancer="role", probe_interval_s=3600.0)),
    }
    yield {"servers": servers, "managers": managers, "plans": plans,
           "proxies": proxies, "nonce": [0]}
    for plan in plans.values():
        plan.write_text(json.dumps({"rules": []}))
    for s in list(proxies.values()) + list(servers.values()):
        s.stop()
    for mgr in managers.values():
        mgr.stop()
    if previous is None:
        os.environ.pop("KFT_ENABLE_FAULTS", None)
    else:
        os.environ["KFT_ENABLE_FAULTS"] = previous


def _arm(fleet_, backend, rules):
    """Rewrite one replica's plan; the nonce seed makes every rewrite a
    FRESH plan (its fire counters reset)."""
    fleet_["nonce"][0] += 1
    fleet_["plans"][backend].write_text(json.dumps(
        {"seed": fleet_["nonce"][0], "rules": rules}))


def _rows(n, seed=1):
    return np.random.RandomState(seed).randint(
        0, 512, (n, PROMPT_LEN)).tolist()


def _port(fleet_, name):
    return fleet_["servers"][name].port


@pytest.mark.parametrize("model", list(MODELS))
def test_tokens_identical_through_either_replica(fleet, model):
    rows = _rows(2, seed=3)
    path = f"/v1/models/{model}:generate"
    bodies = {b: post(_port(fleet, b), path, {"instances": rows})
              for b in ("jax", "port")}
    assert bodies["jax"][0] == 200 and bodies["jax"] == bodies["port"]
    want = unary_tokens(_port(fleet, "jax"), rows, model)
    rr = fleet["proxies"]["rr"].port
    for _ in range(2):  # round robin: one request on each replica
        assert unary_tokens(rr, rows, model, prefix="/model") == want


def _engine(fleet_, backend, model):
    return fleet_["managers"][backend].get_model(model) \
        .get_resident().engine


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_role_split_is_bitwise_across_backends(fleet, direction, model):
    """Prefill on one backend, the handoff blob across packages, decode
    on the other: the tokens are a single replica's, unary and
    streamed, and the decode replica took the slots."""
    prefill, decode = direction.split("_to_")
    before = {b: _engine(fleet, b, model).stats()["admitted"]
              for b in ("jax", "port")}
    proxy = fleet["proxies"][direction].port
    for rows in ([[3, 4, 5]], [[9] * PROMPT_LEN, [1] * PROMPT_LEN]):
        want = unary_tokens(_port(fleet, "jax"), rows, model)
        assert unary_tokens(proxy, rows, model, prefix="/model") == want
    rows = [[2, 3, 4, 5]]
    events = stream_events(proxy, f"/model/{model}:generate",
                           {"instances": rows, "stream": True})
    done = [d for e, d in events if e == "done"][0]
    assert done["tokens"] == unary_tokens(_port(fleet, "port"), rows,
                                          model)
    after = {b: _engine(fleet, b, model).stats()["admitted"]
             for b in ("jax", "port")}
    # Four split rows decoded on the decode replica (the direct
    # reference requests above ride the JAX replica too); a port
    # prefill takes no slot.
    assert after[decode] - before[decode] >= 4
    if prefill == "port":
        assert after["port"] == before["port"] + 1  # the direct request


@pytest.mark.parametrize("model", list(MODELS))
def test_stream_killed_mid_flight_resumes_on_the_other_backend(fleet,
                                                               model):
    """Both replicas kill their first stream after 3 events; the
    proxy resumes each on the other backend (a JAX-minted token on the
    port, a port-minted one on JAX) with a bitwise-identical total
    sequence and no in-band error."""
    from kubeflow_tpu.serving.http_proxy import _P_RESUMES

    rows = _rows(2, seed=7)
    want = unary_tokens(_port(fleet, "jax"), rows, model)
    resumed = _P_RESUMES.labels("resumed").get()
    for backend in ("jax", "port"):
        _arm(fleet, backend, [
            {"match": {"route": "generate", "phase": "stream",
                       "max_fires": 1},
             "action": {"kill_after_events": 3}}])
    rr = fleet["proxies"]["rr"].port
    try:
        for _ in range(4):
            events = stream_events(rr, f"/model/{model}:generate",
                                   {"instances": rows, "stream": True})
            assert not [d for e, d in events if e == "error"], events
            assert [e for e, _ in events].count("done") == 1
            done = [d for e, d in events if e == "done"][0]
            assert done["tokens"] == want
            for r in range(len(rows)):
                toks = [d["token"] for e, d in events
                        if e == "token" and d["row"] == r]
                assert toks == want[r]
            if _P_RESUMES.labels("resumed").get() >= resumed + 2:
                break
        assert _P_RESUMES.labels("resumed").get() == resumed + 2
    finally:
        for backend in ("jax", "port"):
            _arm(fleet, backend, [])


def _resume_leg(port, model, blob, emitted, stop_after=None):
    """One resume leg as the proxy runs it: the blob and the tokens
    relayed since it was minted; returns (the leg's new blob or None,
    its tokens)."""
    events = stream_events(
        port, f"/v1/models/{model}:generate",
        {"resume": [blob], "resume_emitted": [emitted], "stream": True,
         "emit_resume": True}, stop_after=stop_after)
    blobs = [d["blob"] for e, d in events if e == "resume"]
    tokens = [d["token"] for e, d in events if e == "token"]
    return (blobs[0] if blobs else None), tokens


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("first", ["jax", "port"])
def test_second_death_on_a_port_replica_resumes_bitwise(fleet, first,
                                                        model):
    """A stream dies after 2 tokens (its first life on ``first``), is
    resumed on the port and dies again after 1 more; the port's new
    token carries ``prompt_len`` (the original prompt) and resumes on
    the port, split at that prompt, and on the JAX replica, which reads
    the same token by its named keys: both give the uninterrupted
    stream's rest."""
    import base64

    rows = _rows(1, seed=11)
    want = unary_tokens(_port(fleet, "jax"), rows, model)[0]
    events = stream_events(
        _port(fleet, first), f"/v1/models/{model}:generate",
        {"instances": rows, "stream": True, "emit_resume": True},
        stop_after=2)
    blob1 = [d["blob"] for e, d in events if e == "resume"][0]
    life1 = [d["token"] for e, d in events if e == "token"]
    assert life1 == want[:2]
    blob2, life2 = _resume_leg(_port(fleet, "port"), model, blob1, life1,
                               stop_after=1)
    assert life2 == want[2:3]
    raw2 = base64.b64decode(blob2)
    token = wire.decode_resume_token(raw2, model=model, version=1)
    assert token["prompt_len"] == PROMPT_LEN
    ref_token = jax_wire.decode_resume_token(raw2, model=model, version=1)
    np.testing.assert_array_equal(ref_token["prompt_tokens"],
                                  rows[0] + life1)
    assert ref_token["max_new_tokens"] == NEW_TOKENS - 2
    for backend in ("port", "jax"):
        _, rest = _resume_leg(_port(fleet, backend), model, blob2, life2)
        assert life1 + life2 + rest == want, backend
