"""Capture one real torch.profiler trace of the prefetch-fed train loop, or
open a live profiler window on a running caption server — the port of
``scripts/profile_trace.sh`` (Python, so it needs no ``curl``).

Default mode, ``[outdir]`` (default ``runs/torch_profile_trace``): build
the quality corpus under ``<outdir>/profile_run`` (``tools.quality_run
--corpus-only``) unless its ``captions.json`` exists, then run
``python -m sat_tpu_torch.cli --phase=train`` on it for 25 steps at batch
32 with a profiler window over steps 8-12.  The window writes
``<outdir>/profile_run_trace/<stamp>/trace.json``; ``profile_done.txt`` is
written only when the run exits 0 and a complete capture exists (the
trace parses and holds a backward pass of the train step).  The train
run takes the card unless ``SAT_TORCH_DEVICE=cpu``.  ``--extra-set
KEY=VALUE`` (repeatable, the port's addition) goes after the script's
``--set`` list, e.g. small widths for a CPU run.

Live mode, ``--live HOST:PORT [duration_ms]``: ``POST
/profile?duration_ms=N`` to a running server (default 2000 ms).  A reply
carrying ``profile_dir`` prints the body and "profiler window open for N
ms" and exits 0; a capture already running (409) prints "capture already
in progress (409)" and exits 1; an unreachable server or any other reply
exits 1.  This mode never imports torch.  For a *training* process send
SIGUSR2 instead (``kill -USR2 <pid>``): the run opens a window at its
next log boundary.

Usage: python -m sat_tpu_torch.tools.profile_trace [outdir] [--extra-set KEY=VALUE ...]
       python -m sat_tpu_torch.tools.profile_trace --live HOST:PORT [duration_ms]
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = "runs/torch_profile_trace"
LIVE_USAGE = "usage: profile_trace --live HOST:PORT [duration_ms]"
USAGE = ("usage: python -m sat_tpu_torch.tools.profile_trace [outdir] [--extra-set KEY=VALUE ...]\n"
         "       python -m sat_tpu_torch.tools.profile_trace --live HOST:PORT [duration_ms]")


def live(addr: str, duration_ms: str) -> int:
    url = f"http://{addr}/profile?duration_ms={duration_ms}"
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:   # a reply all the same: 409, 503, ...
        body = e.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError):
        print(f"live capture failed: server at {addr} unreachable")
        return 1
    print(body)
    if "profile_dir" in body:
        print(f"profiler window open for {duration_ms} ms")
        return 0
    if "in progress" in body:
        print("capture already in progress (409)")
        return 1
    print("live capture refused")
    return 1


def train_step_events(trace_path: str) -> int:
    """Events of the train step's backward pass in a chrome trace (0 when
    the file does not parse: a capture cut short)."""
    try:
        with open(trace_path) as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, ValueError):
        return 0
    return sum(1 for e in events if str(e.get("name", "")).startswith("autograd::engine::evaluate_function"))


def capture(out: str, extra_set: List[str]) -> int:
    os.makedirs(out, exist_ok=True)
    run = os.path.join(out, "profile_run")
    if not os.path.isfile(os.path.join(run, "captions.json")):
        with open(os.path.join(out, "profile_corpus.log"), "w") as log:
            try:
                rc = subprocess.run(
                    [sys.executable, "-m", "sat_tpu_torch.tools.quality_run", "--corpus-only", "--out", run],
                    stdout=log, stderr=subprocess.STDOUT, cwd=REPO, timeout=300,
                ).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        if rc != 0:
            print("corpus gen failed")
            return 1

    prof = os.path.join(out, "profile_run_trace")
    sets = [
        f"train_image_dir={run}/images",
        f"train_caption_file={run}/captions.json",
        f"vocabulary_file={run}/vocabulary_basic.csv",
        f"temp_annotation_file={run}/anns_basic.csv",
        f"temp_data_file={run}/data_basic.npy",
        f"save_dir={run}/models2",
        f"summary_dir={run}/summary2",
        "max_train_ann_num=none", "batch_size=32", "num_epochs=30",
        "max_steps=25", "save_period=0",
        f"profile_dir={prof}", "profile_start_step=8",
        "profile_num_steps=5",
        *extra_set,
    ]
    argv = [sys.executable, "-m", "sat_tpu_torch.cli", "--phase=train"]
    for s in sets:
        argv += ["--set", s]
    log_path = os.path.join(out, "profile_train.log")
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run(argv, stdout=log, stderr=subprocess.STDOUT, cwd=REPO, timeout=700).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    # a COMPLETE trace only: a window cut by a kill leaves no parseable file
    traces = sorted(glob.glob(os.path.join(prof, "*", "trace.json")))
    if rc == 0 and traces and train_step_events(traces[-1]) > 0:
        line = f"trace captured under {prof}"
        print(line)
        with open(os.path.join(out, "profile_done.txt"), "w") as f:
            f.write(line + "\n")
        return 0
    print(f"trace capture failed (rc={rc}) — see {log_path}")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "--live":
        if len(args) < 2 or not args[1]:
            print(LIVE_USAGE, file=sys.stderr)
            return 1
        return live(args[1], args[2] if len(args) > 2 else "2000")
    extra_set, rest = [], []
    while args:
        a = args.pop(0)
        if a == "--extra-set" and args:
            extra_set.append(args.pop(0))
        elif a.startswith("--extra-set="):
            extra_set.append(a.split("=", 1)[1])
        elif a in ("-h", "--help"):
            print(USAGE)
            return 0
        else:
            rest.append(a)
    if len(rest) > 1 or (rest and rest[0].startswith("-")):
        print(USAGE, file=sys.stderr)
        return 1
    # a relative outdir is taken from the repository root, as the script's is
    return capture(os.path.join(REPO, rest[0] if rest else DEFAULT_OUT), extra_set)


if __name__ == "__main__":
    sys.exit(main())
