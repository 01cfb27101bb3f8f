"""Time one phase of ``chip_smoke.py`` alone, from one or more checkouts, on
one card: each run in a process of its own, in the order given. To compare
two commits on one machine, unpack the earlier one into a git-ignored
directory and give parent, change, change, parent, e.g.

    git archive <commit> | tar -x -C build/ab_parent
    python3 tools/smoke_phase_ab.py --phase avif_phase build/ab_parent . . build/ab_parent

A run imports that checkout's ``chip_smoke.py`` and its ``akari_torch``,
builds and loads what the smoke's phase 1 builds (the CUDA kernels and
every native decoder; a library the checkout already holds is reused), takes
the 2048^2 PNG median that phase 41 takes before it (phases 42-54 reuse it),
then calls the phase as ``main`` does, ``phase(card, traversal, cli_render)``,
and prints one JSON line: the checkout, the card's name and power limit,
and the figures the phase returns (``phase_s`` among them). A run whose
phase fails a check exits non-zero, and so does this script. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def child(checkout, phase):
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as smoke
    from akari_torch.cli import render as cli_render
    from akari_torch.kernels import build as kbuild
    from akari_torch.native import loader as native_loader
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import instanced_tree_intersect as iti
    from akari_torch.ops import tree_intersect as ti

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(smoke.KERNELS) + len(native_loader.SOURCES)) as pool:
        jobs = [pool.submit(native_loader.build, n) for n in native_loader.SOURCES]
        jobs += [pool.submit(kbuild.build, k) for k in smoke.KERNELS]
        for j in jobs:
            j.result()
    for k in smoke.KERNELS:
        kbuild.load(k)
    for n in native_loader.SOURCES:
        native_loader.load(n)
    build_s = time.perf_counter() - t0
    card = smoke.card_line()
    smoke.png_decode_median()
    out = getattr(smoke, phase)(card, (di, ti, iti, ci), cli_render)
    print(json.dumps({"checkout": checkout, "card": card, "build_s": build_s, **out}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", required=True, help="a phase function of chip_smoke.py")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("checkouts", nargs="+")
    args = ap.parse_args(argv)
    if args.child:
        child(args.checkouts[0], args.phase)
        return 0
    rc = 0
    for checkout in args.checkouts:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--phase",
                              args.phase, checkout], stdout=subprocess.PIPE, text=True)
        lines = run.stdout.strip().splitlines()
        sys.stdout.write(run.stdout)
        if run.returncode or not lines or not lines[-1].startswith("{"):
            print(f"smoke_phase_ab: {checkout}: exit {run.returncode}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
