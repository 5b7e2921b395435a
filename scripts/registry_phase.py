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

"""The rest of the registry's phases of ``chip_smoke.py`` alone, on one
GPU.

Builds the kernels, holds the flash kernel at ViT-B/16's and BERT-base's
shapes (rows f and g of the smoke) against its plain version, then runs
``chip_smoke.train_bert`` (the nccl drain agreement, the tpu-lm CLI at
its defaults under the launcher, bert-base's mlm steps and bert-large's
forward), ``train_vision`` (the tpu-cnn path for ViT-B/16, Inception-v3,
VGG-16 and AlexNet, the BN kernel at Inception's shapes, the kernels'
first-step logits against the plain twins), ``serve_vision`` and
``train_moe`` (the MoE pricing pair, served), with every assert of the
full smoke. Run from the repository root::

    python3 scripts/registry_phase.py
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
        print("registry_phase: CUDA is not available", file=sys.stderr)
        return 1
    card = smoke.environment()
    t0 = time.monotonic()
    reports = smoke._build.build_all()
    smoke.log(f"built in {time.monotonic() - t0:.1f} s")
    kernels = smoke.compiler_report(reports["flash_attention"])
    for row in smoke.REGISTRY_FLASH_SHAPES:
        smoke.check_flash(kernels, *row)
    smoke.registry_phases(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
