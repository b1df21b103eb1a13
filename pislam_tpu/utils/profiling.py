"""Timing and tracing helpers for runs on the GPU.

The reference's only tracing is std::clock() bracketing in the demo
(demo.cpp:75-113) plus doc-comment throughput notes; its perf charts
(doc/stage_times.png) break a frame into detect/score/NMS/describe stages.
This module times jitted calls with ``jax.block_until_ready`` (JAX returns
before the device finishes, so a timing without it measures the enqueue),
wraps ``jax.profiler`` for full XLA traces and reduces a trace to its top
device operations -- the per-op breakdown that replaces the reference's
stage chart.

A time is a device number only when it was taken on the GPU: every helper
that reports one names the card (``require_gpu``), and fails without one.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import jax


def gpu_name_and_power() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> str:
    """Fail unless JAX runs on a GPU; returns the card's description
    (device kind, then nvidia-smi's name and power limit)."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {platform!r}; device timings are only "
            "taken on the GPU")
    return f"{jax.devices()[0].device_kind} | {gpu_name_and_power()}"


def median_ms(fn: Callable, *args, reps: int = 20) -> float:
    """Median wall milliseconds of ``fn(*args)`` over `reps` calls, each
    ended by block_until_ready; one untimed warm-up call compiles."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a full XLA profiler trace (TensorBoard/xprof/perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def top_device_ops(logdir: str, n: Optional[int] = None
                   ) -> List[Tuple[str, float, int]]:
    """(name, total device ms, count) of the n longest operations (all when
    n is None) in the newest trace under `logdir`, summed over the GPU
    planes' events."""
    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    tot: Dict[str, float] = collections.defaultdict(float)
    cnt: Dict[str, int] = collections.defaultdict(int)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # kernels and memsets run on the stream lines; keep any other
            # (summary) line from counting them twice
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                tot[ev.name] += ev.duration_ns / 1e6
                cnt[ev.name] += 1
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [(k, v, cnt[k]) for k, v in ranked]
