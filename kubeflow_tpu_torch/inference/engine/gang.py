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

"""The control line of a tensor gang that serves one model.

The reference serves a tensor-sharded model from one controller that
drives every device of its mesh. In the port each rank is a process,
so the ranks must run the same forwards in the same order, or their
collectives pair up wrongly. Rank 0 of each tensor line is the driver:
it alone takes requests (``LoadedModel.run``, the engine's ``submit``),
and before each unit of device work it broadcasts one small object
saying what that work is (:meth:`GangLink.send`). Every other rank
runs ``LoadedModel.follow()``, which receives those objects
(:meth:`GangLink.recv`) and does the same work until rank 0 closes.
The broadcast and the work it announces happen under :attr:`lock` on
rank 0, so a ``run`` on a caller's thread and the engine thread's laps
reach the other ranks in one order.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from kubeflow_tpu_torch.parallel.mesh import tensor_group, tensor_rank


class GangLink:
    """One tensor line's control broadcasts over ``mesh``'s ``tensor``
    group, from the line's rank at tensor position 0."""

    def __init__(self, mesh: Any):
        self.mesh = mesh
        self.group = tensor_group(mesh)
        self.size = mesh.shape["tensor"]
        position = tensor_rank(mesh)
        #: The driver's global rank (``tensor`` is the fastest axis).
        self.src = mesh.rank - position
        self.leader = position == 0
        self.lock = threading.RLock()

    def send(self, message: Any) -> None:
        """Rank 0: broadcast ``message`` (a picklable object)."""
        if not self.leader:
            raise RuntimeError("only the gang's rank 0 drives it")
        torch.distributed.broadcast_object_list([message], src=self.src,
                                                group=self.group)

    def recv(self) -> Any:
        """A follower: the next object rank 0 broadcast."""
        box = [None]
        torch.distributed.broadcast_object_list(box, src=self.src,
                                                group=self.group)
        return box[0]
