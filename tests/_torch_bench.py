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

"""Helpers for the benchmark twins (tests/test_torch_*_bench.py)."""


def key_tree(value):
    """A result's shape without its numbers: a dict's keys (each with
    its value's key tree), a list's items' key trees, else None."""
    if isinstance(value, dict):
        return {k: key_tree(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [key_tree(v) for v in value]
    return None


def assert_same_keys(ours, theirs, path="result"):
    """Every level of ``ours`` has the keys of ``theirs`` and no other."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict), path
        assert set(ours) == set(theirs), (
            f"{path}: only ours {sorted(set(ours) - set(theirs))}, only "
            f"theirs {sorted(set(theirs) - set(ours))}")
        for k in theirs:
            assert_same_keys(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, (list, tuple)):
        assert isinstance(ours, (list, tuple)), path
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_keys(a, b, f"{path}[{i}]")
