"""Share of the traced window in which no operation ran on the device,
in %: 100 x (1 - the union of the device operations' intervals / the
window)."""


def read(run):
    t = run["trace"]
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
