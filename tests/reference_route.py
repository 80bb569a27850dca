"""Run one of damar_tpu's scripts on its device route, the route that
damar_tpu_torch follows, for a comparison of every file the two leave
in their workdirs:

    python tests/reference_route.py [--lift-caps] SCRIPT [ARGS...]
    # e.g. python tests/reference_route.py examples/do.py --cpu W
    #      python tests/reference_route.py --lift-caps scripts/soak.py \\
    #          --workdir W

The device route is DAMAR_BP=jax with native.available -> False: the
bit-parallel kernels and the wide-band retries in JAX, where the CPU
default takes the host C library, whose 64-diagonal retry tier can
trace a record with other diffs (fault 3p, tests/test_torch_retry_
routes.py).  --lift-caps also raises the datander search's buffers
(fault 3g: it cuts at 1 << 20 hits) and the pair seeding's caps (fault
3h) above every hit and seed, as the port sizes them from the counts;
each run prints the tandem search's totals.  Not a test: a 1 Mbp soak
takes about half an hour here on the CPU."""
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    args = sys.argv[1:]
    lift = bool(args) and args[0] == "--lift-caps"
    if lift:
        args = args[1:]
    if not args:
        raise SystemExit(__doc__)
    os.environ["DAMAR_BP"] = "jax"
    sys.path.insert(0, ROOT)
    from damar_tpu import native
    native.available = lambda: False
    if lift:
        from damar_tpu.ops import seeding
        from damar_tpu.pipeline import overlap
        tandem, pair = seeding.find_tandem_seeds, overlap.overlap_pair_device

        def tandem_uncapped(*a, **kw):
            s = tandem(*a, **dict(kw, hit_cap=1 << 27, seed_cap=1 << 22))
            print(f"# tandem search: {s['total_hits']} hits, "
                  f"{s['total_seeds']} seeds", flush=True)
            return s

        seeding.find_tandem_seeds = tandem_uncapped
        overlap.overlap_pair_device = lambda *a, **kw: pair(
            *a, **dict(kw, hit_cap=1 << 28, seed_cap=1 << 22))
    sys.argv = args
    runpy.run_path(args[0], run_name="__main__")


if __name__ == "__main__":
    main()
