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

"""The measuring entry points' phase of ``chip_smoke.py`` alone, on one
GPU.

Builds the kernels, then runs ``chip_smoke.measure_phases``: the
llama3-8b decode sweep through ``inference.benchmark``, the prefix,
tiered-prefix and speculative legs of ``serving.benchmark`` at
llama3-8b, the continuous, gRPC, mixed-load and overload legs at the
reference's models and a ``kft-export`` round trip, with every assert
of the full smoke. Run from the repository root::

    python3 scripts/measure_phase.py
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
        print("measure_phase: CUDA is not available", file=sys.stderr)
        return 1
    card = smoke.environment()
    t0 = time.monotonic()
    smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    smoke.log(f"measure launches {smoke.measure_phases(card)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
