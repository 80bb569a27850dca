"""How many device records torch.profiler drops from its window.

    python3 -m damar_tpu_torch.tools.profile_window [SECONDS]

For SECONDS (default 240), with device work (matmuls) between, profiles
three windows every few seconds: in each, a one-element add, then a
one-element multiply, is launched and synchronized once a millisecond,
N / 2 times each; the second window first sleeps PAD seconds, the third
first launches LEAD one-element fills.  Prints, against the time since
the first profile, how many of the adds and multiplies each window
kept: where in the window its lost records were, and whether idle time
or other records at its start keep them.  Needs a CUDA device.
"""
from __future__ import annotations

import sys
import time

import torch

N, PAD, LEAD = 50, 0.1, 64


def window(x, idle: float, fills: int) -> tuple[int, int]:
    """(adds, multiplies) the profile of one window kept, of N / 2 each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(idle)
        for _ in range(fills):
            x.fill_(0)
        torch.cuda.synchronize()
        for i in range(N):
            if i < N // 2:
                x.add_(1)
            else:
                x.mul_(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            while time.perf_counter() - t < 1e-3:
                pass
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in ev if "add" in e.key.lower()),
            sum(e.count for e in ev if "mul" in e.key.lower()))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dur = float(argv[0]) if argv else 240.0
    if not torch.cuda.is_available():
        raise SystemExit("profile_window: needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.zeros(1, device=dev)
    big = torch.randn(4096, 4096, device=dev)
    t0 = time.time()
    while time.time() - t0 < dur:
        kept = [window(x, idle, fills)
                for idle, fills in ((0, 0), (PAD, 0), (0, LEAD))]
        print(f"{time.time() - t0:.1f} s after the first profile: kept "
              f"(adds, multiplies) of {N // 2} each: {kept[0]}; after "
              f"{PAD} s idle {kept[1]}; after {LEAD} fills {kept[2]}",
              flush=True)
        t = time.time()
        while time.time() - t < 5:
            big = torch.tanh(big @ big)
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
