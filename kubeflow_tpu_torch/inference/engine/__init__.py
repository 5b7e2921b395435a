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

"""Continuous-batching decode engine (slot-based, paged KV cache).

The execution plane behind streaming ``:generate`` serving: a
persistent decode loop over N slots where finished rows retire and
queued requests admit *between* K-token slices (prefill into a free
slot), with the KV cache page-managed (:mod:`paged_kv`) instead of
rebuilt per batch, and tokens streamed back incrementally as they are
sampled. The port runs every lane of the reference's: the plain lane,
the prefix-cache lane (:mod:`prefix_cache`) and its host-RAM tier
(:mod:`kv_tier`), chunked prefill, speculative decoding, KV handoff and
mid-stream resume.
"""

from kubeflow_tpu_torch.inference.engine.engine import (  # noqa: F401
    DecodeEngine,
    EngineConfig,
    GenerateStream,
    PrefillHandoff,
    TokenEvent,
)
from kubeflow_tpu_torch.inference.engine.kv_tier import (  # noqa: F401
    HostKVTier,
)
from kubeflow_tpu_torch.inference.engine.paged_kv import (  # noqa: F401
    PageAllocator,
    PagedKVCache,
)
from kubeflow_tpu_torch.inference.engine.prefix_cache import (  # noqa: F401
    PrefixCache,
    PrefixMatch,
)
from kubeflow_tpu_torch.inference.engine.slots import (  # noqa: F401
    Slot,
    SlotScheduler,
)
