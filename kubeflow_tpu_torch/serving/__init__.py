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

"""Model serving on the GPU (tensorflow_model_server + http-proxy role).

The port's serving plane, module for module the reference's:

- :mod:`signature` / :mod:`export` / :mod:`flax_msgpack`: the on-disk
  model format, versioned directories ``<base>/<N>/`` holding a
  signature map and serialized params, written and read by either
  package.
- :mod:`model`: loads one version onto the card (``LoadedModel``:
  batch buckets, predict / classify / generate, the decode engine).
- :mod:`manager`: the version watcher (hot reload of new ``<N>/``
  dirs; POSIX via the native scanner of :mod:`_native`, object stores
  via :mod:`remote`) and the micro-batching queue.
- :mod:`wire` / :mod:`grpc_server`: the PredictionService wire surface
  (hand-rolled protobuf codec, native gRPC listener on :9000), the SSE
  codec, and the handoff, resume and KV-block blobs.
- :mod:`server`: the model-server process: native gRPC on :9000,
  HTTP/JSON, SSE and gRPC-Web on :8500.
- :mod:`overload`, :mod:`tenancy`, :mod:`faults`,
  :mod:`version_policy`, :mod:`kv_store`: deadlines and admission,
  tenant quotas and fair queueing, the fault-injection seam, the
  version policy grammar and the fleet KV pull-through.

- :mod:`export_cli`: ``kft-export``, a checkpoint into a version dir;
  :mod:`sharding`: a sharded export's writer, its one-card read and its
  gang's read (``fsdp=F, tensor=T`` on F·T ranks).
- A gang: :mod:`server` started with the launcher's gang env serves on
  rank 0 (its ``ModelManager`` announces each load on the serving
  mesh's control line, ``inference/engine/gang.py``) while every other
  rank runs ``ModelManager.follow()``; every eager engine lane runs on
  it.
- :mod:`benchmark`: the serving benchmark's legs.

Not ported: CUDA-graph capture of a gang's engine (ROADMAP A18), the
proxy, the client, and the benchmark's obs-overhead and SLO legs (A16);
the reference's proxy fronts port replicas unchanged."""
