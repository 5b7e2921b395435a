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
# limitations under the License.

"""The LM training phase of ``chip_smoke.py`` alone, on one GPU.

Builds the kernels, makes ``llama3-8b`` at full width from seed 0 in
serving storage (the params the smoke serves), and runs
``chip_smoke.train_lm``: LoRA fine-tuning at full width and depth
through ``run_lora_benchmark``'s run, the merged model served, the LoRA
benchmark's CLI on a token shard, and the depth-4 pretraining step
through the tpu-lm CLI, with every assert of the full smoke. Run from the repository root::

    python3 scripts/train_phase.py
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
        print("train_phase: CUDA is not available", file=sys.stderr)
        return 1
    card = smoke.environment()
    t0 = time.monotonic()
    smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    params = smoke.init_params(
        smoke.get_model(smoke.LLAMA).make(dtype="bfloat16"), seed=0)
    torch.cuda.synchronize()
    launches = smoke.timed(smoke.train_lm, card, params)
    smoke.log(f"train path launches: {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
