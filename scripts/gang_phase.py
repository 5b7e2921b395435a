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

"""The gang phase of ``chip_smoke.py`` alone, on one GPU.

Builds the kernels, makes llama3-8b at full width from seed 0 (bf16, as
the smoke serves it), then runs ``chip_smoke.gang_lm`` (the meshed LoRA
steps on ``data=-1`` and ``fsdp=-1`` of a one-rank nccl group, bitwise
against the unmeshed ones; the two-host checkpoint; the sharded export
is the tensor gang's, ``scripts/tensor_gang.py``) and
``chip_smoke.gang_vision`` (the meshed ResNet-50 step on the
BN sync route; the route's rows and times), with every assert of the
full smoke. Run from the repository root::

    python3 scripts/gang_phase.py [--vision_only]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--vision_only", action="store_true",
                        help="skip the llama3-8b half")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gang_phase: CUDA is not available", file=sys.stderr)
        return 1
    card = smoke.environment()
    t0 = time.monotonic()
    smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    if not args.vision_only:
        entry = smoke.get_model(smoke.LLAMA)
        params = smoke.init_params(entry.make(dtype="bfloat16"), seed=0)
        smoke.log(f"gang llama launches {smoke.gang_lm(card, params)}")
        del params
    launches, _ = smoke.gang_vision(card)
    smoke.log(f"gang resnet launches {launches}")
    smoke.log(f"gang phase: {time.monotonic() - t0:.1f} s from the build")
    return 0


if __name__ == "__main__":
    sys.exit(main())
