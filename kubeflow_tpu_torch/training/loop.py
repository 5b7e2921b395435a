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


"""The training loop: resume → step → log → checkpoint → profile → drain.

The port of ``kubeflow_tpu/training/loop.py``. On every start it
restores the freshest checkpoint of either tier (a first start is a
fresh one), so a restarted job resumes where it was and
loses at most a save interval. A drain signal (SIGTERM by default) lets
the in-flight step finish, force-saves, and raises
:class:`DrainInterrupt`; entry points exit with :data:`DRAIN_EXIT_CODE`
so an operator restarts the job without charging its restart budget.
In a gang (a ``torch.distributed`` group of more than one process,
``training/launcher.py``) the processes agree on the drain: every
``drain_sync_steps`` steps each contributes its own drain flag to an
all-reduce MAX (the reference's ``process_allgather`` + ``any``), and
all drain at the same step if any saw the signal. A gang's ``fit``
checkpoints as the reference's gang does: each tier's ``num_hosts`` and
``host_id`` are the gang's size and this process's rank, every rank
writes its host shard at the same steps, and each resumes from the
step's shards (``training/checkpoint.py``). The step function decides
what the gang computes: a mesh trainer's step (``training/lm.py``,
``finetune.py``, ``train.py``) keeps one global state across the ranks.

Metrics: every log window publishes ``kft_training_step_seconds``,
``kft_training_steps_per_sec`` and ``kft_training_steps_total`` through
``obs/metrics.py`` and writes a JSONL record (``utils/metrics.py``).
Profiling: ``torch.profiler`` over ``[profile_start, profile_stop)``,
written as a Chrome trace under ``profile_dir``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.training.launcher import DRAIN_EXIT_CODE  # noqa: F401
from kubeflow_tpu_torch.training.checkpoint import (
    CheckpointConfig,
    ContinuousCheckpointConfig,
    ShardedCheckpointer,
)
from kubeflow_tpu_torch.utils.metrics import MetricsLogger

logger = logging.getLogger(__name__)


_T_STEP_SECONDS = obs_metrics.Histogram(
    "kft_training_step_seconds",
    "Mean per-step wall time over each log window")
_T_STEPS_PER_SEC = obs_metrics.Gauge(
    "kft_training_steps_per_sec",
    "Training throughput over the last log window")
_T_STEPS = obs_metrics.Counter(
    "kft_training_steps_total", "Optimizer steps completed")


class DrainInterrupt(Exception):
    """Raised by ``fit`` after a drain signal: the in-flight step
    finished and (if checkpointing) a checkpoint is durable at
    ``.step``."""

    def __init__(self, step: int, checkpointed: bool):
        super().__init__(
            f"drained at step {step} "
            f"({'checkpoint saved' if checkpointed else 'no checkpoint'})")
        self.step = step
        self.checkpointed = checkpointed


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 10
    checkpoint: Optional[CheckpointConfig] = None
    # The continuous sharded tier, alongside the periodic one; on start
    # the loop restores whichever holds the freshest step.
    continuous: Optional[ContinuousCheckpointConfig] = None
    metrics_path: Optional[str] = None
    # torch.profiler capture over [start, stop) in resumed step numbers
    # (stop defaults to start + 3), a Chrome trace under profile_dir.
    profile_start: Optional[int] = None
    profile_stop: Optional[int] = None
    profile_dir: str = "kft-profile"
    # Drain on any of these signals; installed only when fit runs on the
    # main thread (the signal API's rule). () disables.
    drain_signals: Tuple[int, ...] = (signal.SIGTERM,)
    # A gang agrees on the drain every N steps (a collective save must
    # not start on one process while its peers step on): up to N extra
    # steps run inside the grace period, so keep N * step_time well
    # under terminationGracePeriodSeconds.
    drain_sync_steps: int = 5


def _gang() -> bool:
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def gang_config(config: CheckpointConfig) -> CheckpointConfig:
    """A tier's config with the gang's size and this process's rank as
    ``num_hosts`` and ``host_id`` (as the reference's CLIs pass
    ``jax.process_count()`` and ``process_index()``); a config that
    names another host count raises."""
    dist = torch.distributed
    if not _gang():
        return config
    world, rank = dist.get_world_size(), dist.get_rank()
    if config.num_hosts not in (1, world):
        raise ValueError(f"checkpoint num_hosts={config.num_hosts} in a "
                         f"gang of {world}")
    return dataclasses.replace(config, num_hosts=world, host_id=rank)


def agree_on_drain(requested: bool) -> bool:
    """Whether any process of the gang asked to drain: an all-reduce MAX
    of each process's flag, on the card for an nccl group and on the
    host for gloo. Every process must call it at the same steps."""
    dist = torch.distributed
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([int(requested)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _profiler(config: LoopConfig):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, config: LoopConfig) -> None:
    prof.stop()
    os.makedirs(config.profile_dir, exist_ok=True)
    path = os.path.join(config.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def fit(state: Any,
        step_fn: Callable[[Any, Any], Tuple[Any, Dict[str, torch.Tensor]]],
        batches: Iterator[Any], config: LoopConfig, *,
        metrics_logger: Optional[MetricsLogger] = None,
        hooks: Optional[list] = None) -> Any:
    """Run up to ``config.total_steps`` (counting resumed steps).

    ``hooks``: callables ``(step, state, metrics) -> None`` invoked at
    every log interval."""
    # Both tiers are the one sharded writer, each at its own interval,
    # writing this rank's host shard in a gang.
    ckpt = (ShardedCheckpointer(gang_config(config.checkpoint))
            if config.checkpoint else None)
    cont = (ShardedCheckpointer(gang_config(config.continuous))
            if config.continuous else None)
    tiers = [t for t in (cont, ckpt) if t]
    owns_logger = metrics_logger is None
    metrics_logger = metrics_logger or MetricsLogger(config.metrics_path)

    # Restore the freshest tier: the continuous shards usually lead the
    # periodic step.
    if ckpt or cont:
        mono_step = ckpt.latest_step() if ckpt else None
        cont_step = cont.latest_step() if cont else None
        if cont_step is not None and (mono_step is None
                                      or cont_step >= mono_step):
            state = cont.restore(state)
        elif ckpt:
            state = ckpt.restore(state)
    start_step = int(state.step)
    if start_step >= config.total_steps:
        logger.info("checkpoint already at step %d >= total %d; done",
                    start_step, config.total_steps)
        for tier in tiers:
            tier.close()
        if owns_logger:
            metrics_logger.close()
        return state

    # The handler only sets a flag; the loop reads it between steps, so
    # the in-flight step completes and the save is a real step boundary.
    drain_requested = threading.Event()
    prev_handlers = {}
    if (config.drain_signals
            and threading.current_thread() is threading.main_thread()):
        def _on_drain(signum, frame):
            del frame
            logger.info("drain signal %d: finishing in-flight step, then "
                        "checkpoint + exit", signum)
            drain_requested.set()

        for sig in config.drain_signals:
            prev_handlers[sig] = signal.signal(sig, _on_drain)

    gang = _gang()
    prof = None
    window_start = time.perf_counter()
    window_steps = 0
    metrics: Dict[str, torch.Tensor] = {}
    try:
        for step in range(start_step, config.total_steps):
            if gang:
                # Every process reaches these steps (same start step,
                # same stride), so the collectives line up.
                drain_now = (
                    (step - start_step) % max(config.drain_sync_steps, 1)
                    == 0 and agree_on_drain(drain_requested.is_set()))
            else:
                drain_now = drain_requested.is_set()
            if drain_now:
                drained_step = int(state.step)
                for tier in tiers:
                    tier.save(drained_step, state, force=True)
                    tier.wait()
                logger.info("drained at step %d (checkpoint %s)",
                            drained_step,
                            "saved" if tiers else "not configured")
                raise DrainInterrupt(drained_step, bool(tiers))
            if (config.profile_start is not None
                    and step == config.profile_start):
                prof = _profiler(config)
            batch = next(batches)
            state, metrics = step_fn(state, batch)
            window_steps += 1

            next_step = step + 1
            if prof is not None and next_step == (
                    config.profile_stop or config.profile_start + 3):
                float(metrics["loss"])  # the fence, inside the trace
                _stop_profiler(prof, config)
                prof = None
            if (next_step % config.log_every == 0
                    or next_step == config.total_steps):
                # The host pulls fence the window.
                host_metrics = {k: float(v) for k, v in metrics.items()}
                elapsed = time.perf_counter() - window_start
                host_metrics["steps_per_sec"] = window_steps / max(
                    elapsed, 1e-9)
                _T_STEP_SECONDS.observe(elapsed / max(window_steps, 1))
                _T_STEPS_PER_SEC.set(host_metrics["steps_per_sec"])
                _T_STEPS.inc(window_steps)
                metrics_logger.log(next_step, host_metrics)
                logger.info("step %d: %s", next_step, host_metrics)
                for hook in hooks or ():
                    hook(next_step, state, host_metrics)
                window_start = time.perf_counter()
                window_steps = 0
            for tier in tiers:
                tier.save(next_step, state)
        for tier in tiers:
            tier.save(int(state.step), state, force=True)
            tier.wait()
    finally:
        for sig, handler in prev_handlers.items():
            # None means a handler installed from C: the closest restore
            # is the default. Leaving ours would bind a later SIGTERM to
            # this finished run's flag.
            signal.signal(sig, signal.SIG_DFL if handler is None
                          else handler)
        if prof is not None:
            prof.stop()
        for tier in tiers:
            tier.close()
        if owns_logger:
            metrics_logger.close()
    return state
