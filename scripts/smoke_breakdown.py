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

"""Where a phase of ``chip_smoke.py`` spends its wall time, on one GPU.

Wraps every function of ``chip_smoke`` so that each call adds its
inclusive wall seconds to that function's total (a function's own
recursive calls are counted once), builds the kernels, makes llama3-8b
at full width from seed 0, and runs ``serve_engine``, ``serve_prefix``
and ``serve_chunked`` (whose B=1 streams ``serve_captured`` holds its
captured engines to), ``serve_captured`` and then ``serve_manager`` on
it, as the smoke does. Prints each phase's wall and its functions by
total time, and writes them as JSON. The phases' own asserts hold as in
the smoke. Run from the repository root::

    python3 scripts/smoke_breakdown.py [--out breakdown.json]

A function's total includes the functions it calls, so the rows
overlap; ``device_window`` is the profiler's window and the work run
inside it.

``--whole`` runs the whole smoke (``chip_smoke.main``, its result lines
included) with every function timed the same way, and reports each
function's total over the run: where the smoke's 1,200 s go::

    python3 scripts/smoke_breakdown.py --whole [--out breakdown.json]
"""

import argparse
import collections
import functools
import inspect
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

TOTAL = collections.defaultdict(float)
CALLS = collections.Counter()
_ACTIVE = threading.local()


def _timed(name, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        active = getattr(_ACTIVE, "names", None)
        if active is None:
            active = _ACTIVE.names = set()
        if name in active:
            return fn(*args, **kwargs)
        active.add(name)
        t0 = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            TOTAL[name] += time.monotonic() - t0
            CALLS[name] += 1
            active.discard(name)
    return inner


def instrument():
    """Every plain function of ``chip_smoke`` (not its context managers
    or ``log``) timed in place: the module's own calls go through the
    wrappers."""
    for name, fn in list(vars(smoke).items()):
        if (inspect.isfunction(fn) and fn.__module__ == smoke.__name__
                and name not in ("log", "main")
                and not hasattr(fn, "__wrapped__")):
            setattr(smoke, name, _timed(name, fn))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="")
    parser.add_argument("--whole", action="store_true",
                        help="time every function over the whole smoke")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("smoke_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    instrument()
    if args.whole:
        return whole(args.out)
    card = smoke.environment()
    smoke._build.build_all()
    params = smoke.init_params(
        smoke.get_model(smoke.LLAMA).make(dtype="bfloat16"), seed=0)
    torch.cuda.synchronize()
    kw = {"dtype": "bfloat16"}
    report = {"card": card}
    captured = refs = None
    for phase in ("serve_engine", "serve_prefix", "serve_chunked",
                  "serve_captured", "serve_manager"):
        TOTAL.clear()
        CALLS.clear()
        t0 = time.monotonic()
        if phase == "serve_engine":
            _, vanilla = smoke.serve_engine(card, smoke.LLAMA, params, kw)
            refs = {"engine": {m: vanilla[m][1] for m in vanilla}}
        elif phase == "serve_prefix":
            _, refs["prefix"] = smoke.serve_prefix(card, smoke.LLAMA,
                                                   params, kw)
        elif phase == "serve_chunked":
            _, refs["chunk"] = smoke.serve_chunked(card, smoke.LLAMA,
                                                   params, kw)
        elif phase == "serve_captured":
            captured = smoke.serve_captured(card, smoke.LLAMA, params, kw,
                                            refs)
        else:
            smoke.serve_manager(card, smoke.LLAMA, params, kw, captured)
        wall = time.monotonic() - t0
        rows = sorted(TOTAL.items(), key=lambda kv: -kv[1])
        report[phase] = {"wall_s": wall, "functions": [
            [name, seconds, CALLS[name]] for name, seconds in rows]}
        smoke.log(f"breakdown {phase}: {wall:.1f} s [{card}]")
        for name, seconds in rows[:15]:
            smoke.log(f"  {name}: {seconds:.2f} s in {CALLS[name]} calls")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


def whole(out: str) -> int:
    """The smoke end to end, then each function's total seconds."""
    t0 = time.monotonic()
    sys.argv = [sys.argv[0]]
    rc = smoke.main()
    wall = time.monotonic() - t0
    rows = sorted(TOTAL.items(), key=lambda kv: -kv[1])
    smoke.log(f"breakdown: the smoke {wall:.1f} s, exit {rc}")
    for name, seconds in rows[:60]:
        smoke.log(f"  {name}: {seconds:.2f} s in {CALLS[name]} calls")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"wall_s": wall, "rc": rc, "functions": [
                [name, seconds, CALLS[name]] for name, seconds in rows]},
                f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
