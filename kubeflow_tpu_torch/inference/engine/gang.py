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

"""The control line of a gang of ranks that serves on one serving mesh.

The reference serves a sharded model from one controller that drives
every device of its mesh. In the port each rank is a process, so the
ranks must run the same forwards in the same order, or their collectives
pair up wrongly. The serving mesh's rank 0 (fsdp and tensor position 0)
is the driver: it alone takes requests (``LoadedModel.run``, the
engine's ``submit``, a ``ModelManager``'s loads), and before each unit
of device work it broadcasts one small object saying what that work is
(:meth:`GangLink.send`) over the mesh's serving group
(``mesh.group(SERVING_AXES)``: fsdp outer, tensor inner). Every other
rank receives those objects (:meth:`GangLink.recv`) and does the same
work until rank 0 closes: ``LoadedModel.follow()`` for one model, or
``ModelManager.follow()`` for every model rank 0's manager holds.

Each message rides a *channel*: ``None`` for the manager's own messages
(a load, the end), or a model version's ``(name, version)`` key
(:meth:`GangLink.channel`), so one follower loop serves every model of
the line. The broadcast and the work it announces happen under
:attr:`GangLink.lock` on rank 0, one lock for the whole line, so a
``run`` on a caller's thread, every engine thread's laps and the
manager's loads reach the other ranks in one order.
"""

from __future__ import annotations

import threading
from typing import Any, Hashable, Optional, Tuple

import torch

from kubeflow_tpu_torch.serving.sharding import SERVING_AXES


class GangLink:
    """The serving mesh's control line: broadcasts from the mesh's rank
    0 over its serving group. ``mesh=None`` takes the whole
    ``torch.distributed`` group (a serving mesh spans it: a manager's
    line exists before its first load builds a mesh)."""

    def __init__(self, mesh: Any = None):
        dist = torch.distributed
        if mesh is None:
            self.group = dist.group.WORLD
            self.size = dist.get_world_size()
            rank = dist.get_rank()
            self.src = 0
            self.leader = rank == 0
        else:
            self.group = mesh.group(SERVING_AXES)
            self.size = mesh.axes_size(SERVING_AXES)
            position = mesh.index(SERVING_AXES)
            # The driver's global rank: this rank's coordinates with the
            # serving axes at 0 (the mesh's ranks run row-major).
            here = mesh.coords()
            self.src = next(
                r for r in range(mesh.size)
                if all(mesh.coords(r)[a] == (0 if a in SERVING_AXES
                                             else here[a])
                       for a in here))
            self.leader = position == 0
        self.lock = threading.RLock()

    def send(self, message: Any, channel: Optional[Hashable] = None) -> None:
        """Rank 0: broadcast ``message`` (a picklable object) on
        ``channel``."""
        if not self.leader:
            raise RuntimeError("only the gang's rank 0 drives it")
        torch.distributed.broadcast_object_list([(channel, message)],
                                                src=self.src,
                                                group=self.group)

    def recv(self) -> Tuple[Optional[Hashable], Any]:
        """A follower: the next ``(channel, message)`` rank 0 broadcast."""
        box = [None]
        torch.distributed.broadcast_object_list(box, src=self.src,
                                                group=self.group)
        return box[0]

    def channel(self, key: Hashable) -> "GangChannel":
        """The line's view for one model version ``key``."""
        return GangChannel(self, key)


class GangChannel:
    """One model version's messages on a :class:`GangLink`: its
    ``send`` tags each message with the channel's key; the lock, the
    leader and the size are the line's."""

    def __init__(self, link: GangLink, key: Hashable):
        self.link = link
        self.key = key

    @property
    def lock(self) -> threading.RLock:
        return self.link.lock

    @property
    def leader(self) -> bool:
        return self.link.leader

    @property
    def size(self) -> int:
        return self.link.size

    def send(self, message: Any) -> None:
        self.link.send(message, self.key)

    def recv(self) -> Any:
        """The next message, which must be this channel's (a lone
        model's follower: nothing else rides its line)."""
        channel, message = self.link.recv()
        if channel != self.key:
            raise RuntimeError(f"gang message on channel {channel!r} "
                               f"reached the follower of {self.key!r}")
        return message
