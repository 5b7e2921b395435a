#!/usr/bin/env python3
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

"""The serving-plane phase of ``chip_smoke.py`` alone, on one GPU.

Builds the kernels, makes ``llama3-8b`` at full width from seed 0, and
runs ``chip_smoke.serve_manager``: ``ServedModel`` / ``ModelManager``
greedy and sampled (unary, streamed, role-split and resumed generates,
a second death, the micro-batcher, the llama-test load path), with
every assert of the full smoke. About 3–4 minutes of command time
where the full smoke takes ~10. Run from the repository root::

    python3 scripts/manager_phase.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("manager_phase: CUDA is not available", file=sys.stderr)
        return 1
    card = smoke.environment()
    t0 = time.monotonic()
    smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    params = smoke.init_params(
        smoke.get_model(smoke.LLAMA).make(dtype="bfloat16"), seed=0)
    torch.cuda.synchronize()
    smoke.timed(smoke.serve_manager, card, smoke.LLAMA, params,
                {"dtype": "bfloat16"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
