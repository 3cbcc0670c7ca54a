"""How many of a short call's kernel launches ``torch.profiler`` records,
with and without a pause at each end of the profiled window.

The profiler keeps a device activity only where it lies inside the window
between its start and its stop on the host's clock; where the device's
timestamps and the host's disagree, the launches of a window shorter than
the disagreement are dropped without a word. This script profiles ``TRIES``
windows of ``CALLS`` calls of B7's forward (a ctypes launch) and of one
PyTorch op at each pause in ``PAUSES_S``, in turns, and prints one JSON line
a pause and call: how many windows recorded all, some and none of their
launches, and the recorded kernels' earliest start and latest end (µs,
the profiler's clock) against the host's window.

With ``--drift SECONDS`` it instead keeps the card busy with products for
that long and, every ``--every`` seconds, profiles one launch of an
elementwise op between pauses of ``DRIFT_PAUSE_S`` and prints how far the
kernel's start on the profiler's clock lies after the start of its
``cudaLaunchKernel`` call on the host (never less than 0 on one clock), and
how many of 5 launches of B7's forward a window without pauses recorded.

    PYTHONPATH=src python examples/profiler_window_probe_torch.py
    PYTHONPATH=src python examples/profiler_window_probe_torch.py --drift 420

Needs the card and ``nvcc`` (builds B7 at first use).
"""
import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import rope

CALLS = 5
TRIES = 40
PAUSES_S = (0.0, 0.002, 0.02)
DRIFT_PAUSE_S = 0.1


def window(fn, pause: float, name: str) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if pause:
            time.sleep(pause)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if pause:
            time.sleep(pause)
        host_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name]
    return {"seen": len(events), "host_us": host_us,
            "first_start_us": min((e.time_range.start for e in events), default=None),
            "last_end_us": max((e.time_range.end for e in events), default=None)}


def lag(x) -> dict:
    """One launch of ``x.mul_`` between long pauses: its kernel's start less
    its ``cudaLaunchKernel``'s start (µs, both on the profiler's clock)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(DRIFT_PAUSE_S)
        x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(DRIFT_PAUSE_S)
    events = prof.events()
    launch = [e for e in events if e.name == "cudaLaunchKernel"]
    kernel = [e for e in events if e.device_type == DeviceType.CUDA]
    if len(launch) != 1 or len(kernel) != 1:
        return {"launches": len(launch), "kernels": len(kernel)}
    return {"lag_us": kernel[0].time_range.start - launch[0].time_range.start}


def drift(seconds: float, every: float, calls: dict) -> None:
    dev = torch.device("cuda")
    a = torch.randn((4096, 4096), device=dev, dtype=torch.bfloat16)
    x = torch.randn((1024,), device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        while time.perf_counter() - t < every:
            for _ in range(50):
                a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize()
        print(json.dumps({"age_s": time.perf_counter() - t0, **lag(x),
                          "rope_seen_of_5": window(calls["rope_qk_fwd_kernel"], 0.0,
                                                   "rope_qk_fwd_kernel")["seen"]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--drift", type=float, default=0.0)
    ap.add_argument("--every", type=float, default=15.0)
    args = ap.parse_args()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((4, 1024, 24, 128), generator=gen, device=dev).bfloat16()
    k = torch.randn((4, 1024, 8, 128), generator=gen, device=dev).bfloat16()
    pos = torch.arange(1024, device=dev).expand(4, 1024)
    x = torch.randn((4096, 1024), generator=gen, device=dev)
    calls = {"rope_qk_fwd_kernel": lambda: rope.rope_qk_fwd(q, k, pos, 1e4),
             "elementwise": lambda: x.mul_(1.0)}
    for fn in calls.values():
        fn()
    if args.drift:
        drift(args.drift, args.every, calls)
        return
    runs = {(p, c): [] for p in PAUSES_S for c in calls}
    for _ in range(TRIES):
        for p in PAUSES_S:
            for c, fn in calls.items():
                runs[p, c].append(window(fn, p, c))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    for (p, c), rs in runs.items():
        seen = [r["seen"] for r in rs]
        print(json.dumps({"pause_s": p, "call": c, "calls": CALLS, "windows": len(rs),
                          "all": sum(s == CALLS for s in seen),
                          "some": sum(0 < s < CALLS for s in seen),
                          "none": sum(s == 0 for s in seen), "more": sum(s > CALLS for s in seen),
                          "host_us": [round(r["host_us"], 1) for r in rs[:6]],
                          "first_start_us": [r["first_start_us"] for r in rs[:6]],
                          "last_end_us": [r["last_end_us"] for r in rs[:6]],
                          "smi": smi.strip()}), flush=True)


if __name__ == "__main__":
    main()
