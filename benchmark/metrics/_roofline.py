"""A kernel's share of its roofline over the traced window: the work
that the window's records need (benchmark/work.py) at the peak, over
the kernel's device time in the trace."""
from benchmark import tracing, work


def share(run: dict, kernel: str):
    if not run["records"]:
        return None
    rows = sum(work.rows(*r)[kernel] for r in run["records"])
    secs = tracing.kernel_seconds(run["trace"]["device_s"], kernel)
    return work.roofline_pct(kernel, rows, secs)
