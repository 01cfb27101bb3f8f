"""Profiling (``akari_tpu/utils/profiler.py``): named wall-time spans with
a sorted table, per-call timing of one function, and ``torch.profiler``
traces.

``Profiler.frame`` waits for the card at the span's end, so a span holds
the device work it enqueued, and marks the span with
``torch.profiler.record_function`` (the JAX package's ``named_scope``),
so it shows in a trace by name. ``kernel_timer`` times with CUDA events
when the function returns CUDA tensors and with ``perf_counter``
otherwise. ``trace`` writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch


def _sync():
    """Wait for the card, if this process has started CUDA."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    """Named-span accumulator with a sorted report (the reference's
    ``print_kernel_stats``)."""

    def __init__(self):
        self.stats = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])

    @contextlib.contextmanager
    def frame(self, name):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            _sync()
        dt = time.perf_counter() - t0
        s = self.stats[name]
        s[0] += 1
        s[1] += dt
        s[2] = min(s[2], dt)
        s[3] = max(s[3], dt)

    def print_stats(self, stream=None):
        stream = stream or sys.stderr
        rows = sorted(self.stats.items(), key=lambda kv: -kv[1][1])
        stream.write(
            f"{'span':<32}{'calls':>8}{'total(ms)':>12}{'min(ms)':>10}"
            f"{'max(ms)':>10}{'avg(ms)':>10}\n"
        )
        for name, (n, total, mn, mx) in rows:
            stream.write(
                f"{name:<32}{n:>8}{1e3 * total:>12.2f}{1e3 * mn:>10.3f}"
                f"{1e3 * mx:>10.3f}{1e3 * total / max(n, 1):>10.3f}\n"
            )


def _on_cuda(out):
    """Whether ``out`` (a tensor or nested tuples / lists / dicts of them)
    holds a CUDA tensor."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    return False


def kernel_timer(fn, *args, warmup=1, iters=5, **kwargs):
    """Seconds per call of ``fn(*args, **kwargs)``: the least of ``iters``
    after ``warmup`` calls (at least one). CUDA events around each call
    when it returns CUDA tensors, ``perf_counter`` around it otherwise."""
    for _ in range(max(warmup, 1)):  # one call at least: it tells the device
        out = fn(*args, **kwargs)
    _sync()
    cuda = _on_cuda(out)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return min(times)


@contextlib.contextmanager
def trace(logdir=None):
    """``torch.profiler`` trace of the enclosed work (the card's kernels
    when CUDA is available), written as ``<logdir>/trace.json`` in the
    Chrome trace format (chrome://tracing, Perfetto). ``logdir`` defaults
    to ``akari-trace`` under the temporary directory. Yields the
    profiler."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "akari-trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
