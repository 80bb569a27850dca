"""The traced run: the benchmark's spans around its calls into the
program, torch.profiler over the window, and the reduction of the trace
to device time, idle time and the breakdown.

Spans are torch.profiler.record_function ranges named "bench.<span>",
so they share the trace's clock with the device's operations.  The
window is the span "bench.window".  Busy time is the union of every
device operation's interval (kernels, copies, fills) within the window,
not a sum of their durations: two streams' operations that overlap count
once.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import sys

import torch

PREFIX = "bench."
WINDOW = PREFIX + "window"
UNIT = PREFIX + "unit"
# torch.profiler loses the first records of a window: this many throwaway
# operations open every traced window
THROWAWAY = 256


def wrap_spans(spans: dict) -> list:
    """Wrap each named program call in a span: {span: (module, attr)}.
    A call the program no longer has is skipped and named on stderr.
    Returns what unwrap_spans needs to put the originals back."""
    saved = []
    for span, (mod_name, attr) in spans.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr, None)
        if fn is None:
            print(f"# span {span}: {mod_name}.{attr} not found, not traced",
                  file=sys.stderr)
            continue

        def wrapped(*a, __fn=fn, __name=PREFIX + span, **kw):
            with torch.profiler.record_function(__name):
                return __fn(*a, **kw)

        functools.update_wrapper(wrapped, fn)
        setattr(mod, attr, wrapped)
        saved.append((mod, attr, fn))
    return saved


def unwrap_spans(saved: list) -> None:
    for mod, attr, fn in saved:
        setattr(mod, attr, fn)


@contextlib.contextmanager
def traced(device):
    """torch.profiler over the block, CPU and CUDA, opened by THROWAWAY
    small operations that fall before the window's span."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        x = torch.zeros(1, device=device)
        for _ in range(THROWAWAY):
            x.add_(1)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        yield prof


def _union(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(prof, top: int = 10) -> dict:
    """Busy and window seconds, device seconds by operation name, the
    ten operations with the most device time and the ten longest idle
    gaps, each named by the spans open in its middle."""
    from torch.autograd import DeviceType
    win = None
    dev: list[tuple[int, int, str]] = []
    spans: list[tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                win = (s, t)
            elif name.startswith(PREFIX):
                spans.append((s, t, name[len(PREFIX):]))
        elif e.device_type() == DeviceType.CUDA and not name.startswith(
                PREFIX):
            # (a span's range is also shown on the device's timeline)
            dev.append((s, t, name))
    if win is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win
    clipped = [(max(s, w0), min(t, w1), n) for s, t, n in dev
               if t > w0 and s < w1]
    busy_iv = _union([(s, t) for s, t, _ in clipped])
    busy = sum(t - s for s, t in busy_iv)
    by_name: dict[str, int] = {}
    for s, t, n in clipped:
        by_name[n] = by_name.get(n, 0) + (t - s)
    gaps, prev = [], w0
    for s, t in busy_iv + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    gaps.sort(key=lambda g: g[0] - g[1])

    def open_at(ns: int) -> str:
        names = sorted({n for s, t, n in spans if s <= ns < t and
                        n != "unit"})
        return "+".join(names) or ("unit.other" if any(
            s <= ns < t for s, t, n in spans if n == "unit") else
            "between_units")

    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        device_s={n: v / 1e9 for n, v in by_name.items()},
        device_ops=[[n[:160], v / 1e9] for n, v in top_ops],
        idle_gaps=[[open_at((a + b) // 2), (b - a) / 1e9]
                   for a, b in gaps[:top]])


def kernel_seconds(device_s: dict, kernel: str) -> float:
    """Device seconds of the operations whose name holds `kernel`."""
    return sum(v for n, v in device_s.items() if kernel in n)
