"""Attribute the port's bench step time to pipeline stages
(``tools/profile_step.py`` for ``akari_torch``).

Decomposes the fwd + bwd step of ``bench_torch.py`` (Cornell 256x256, 4
spp, depth 5, the sharded pixel loss and its gradient with respect to the
texel values) into pieces and times each with ``bench_torch.step_times``,
the bench's one clock (CUDA events around each call on the current
stream, a synchronize after it; ``perf_counter`` on the CPU): the median
of ``--iters`` calls after ``bench_torch.WARMUP`` warm-ups. The rows are
those of ``tools/profile_step.py``; the one-hot ``gather_rows`` row is the
port's row gather, ``soa.gather_rows_t``.

Then one step runs under ``torch.profiler`` as
``tools/profile_torch_render.py`` profiles it: its device busy time, idle
share (1 - device busy / profiled wall) and CUDA launches. Prints a line a
row, that line, the markdown table (ms, quartiles, share of the step) and,
last, a JSON line of the rows' median ms.

``--trace [DIR]`` also writes a Chrome trace of one step
(``akari_torch.utils.profiler.trace``; DIR defaults to ``akari-trace``
under the temporary directory). ``--device cpu`` is a rehearsal (host
times; no device time is measured there).

Usage: python tools/profile_step_torch.py [--iters 10] [--trace [DIR]]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    help="write a Chrome trace of one step (to DIR)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_step_torch: no CUDA device available (--device cpu rehearses)",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, HERE]
    import bench_torch as bench
    from profile_torch_render import profiled, stats, traversal_kernels

    from akari_torch.diff.inverse import apply_params, scene_params
    from akari_torch.integrators.path import PathConfig, camera_rays, render
    from akari_torch.ops.intersect import intersect
    from akari_torch.parallel import loss_and_image_sharded
    from akari_torch.parallel.render import loss_and_image
    from akari_torch.shading import soa
    from akari_torch.utils.profiler import trace

    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    card = bench.card_line(device)
    scene, camera, cfg, mesh, target = bench.bench_setup(device)
    width, height = camera.width, camera.height
    n = width * height * cfg.spp  # rays of one wavefront (one chunk)

    def step():
        return bench.bench_step(scene, camera, cfg, mesh, target)

    def loss_sharded():
        with torch.no_grad():
            return loss_and_image_sharded(scene, camera, cfg, mesh, target)[0]

    def step_no_mesh(cfg_):
        p = scene_params(scene)
        p["tex_value"].requires_grad_(True)
        loss, _ = loss_and_image(apply_params(scene, p), camera, cfg_, target)
        loss.backward()
        return loss.detach()

    pix = torch.arange(n, dtype=torch.int64, device=device)
    smp = torch.zeros(n, dtype=torch.int64, device=device)

    def isect_chain():
        o, d = camera_rays(camera, 0, smp, pix)
        acc = intersect(scene, o, d).t
        for _ in range(cfg.max_depth):  # the fused shadow + extension launch: 2n rays
            h2 = intersect(scene, torch.cat([o, o]), torch.cat([d, -d]))
            acc = acc + h2.t[:n]
        return acc

    o, d = camera_rays(camera, 0, smp, pix)
    o2, d2 = torch.cat([o, o]), torch.cat([d, d])
    ids = torch.arange(n, dtype=torch.int64, device=device) % scene.prim_table.shape[0]
    cfg1 = PathConfig(spp=cfg.spp, max_depth=1, remat=False)

    rows = []

    def add(name, fn):
        s = bench.timed(fn, device, iters=args.iters)
        rows.append((name, s))
        print(f"{name:<52} {s['median_ms']:10.3f} ms (quartiles {s['q1_ms']:.3f} / "
              f"{s['q3_ms']:.3f})", flush=True)

    add("step fwd+bwd (bench metric)", step)
    add("loss fwd only (sharded)", loss_sharded)
    add("render fwd (no mesh or loss)", lambda: render(scene, camera, cfg, seed=0))
    add("camera + 6 intersect launches (1x n + 5x 2n)", isect_chain)
    add("camera_rays only", lambda: camera_rays(camera, 0, smp, pix))
    add("single intersect launch (n rays)", lambda: intersect(scene, o, d))
    add("single intersect launch (2n rays)", lambda: intersect(scene, o2, d2))
    add("gather_rows_t prim_table [n]", lambda: soa.gather_rows_t(scene.prim_table, ids))
    add("render fwd depth-1 (camera + 1 bounce + 2 intersect)",
        lambda: render(scene, camera, cfg1, seed=0))
    add("step fwd+bwd depth-1 (no mesh)", lambda: step_no_mesh(cfg1))
    add("step fwd+bwd (no mesh)", lambda: step_no_mesh(cfg))

    traversal = traversal_kernels()
    events, wall_ms, _, _ = profiled(step, traversal)
    st = stats(events, wall_ms, traversal, top=5)
    print(json.dumps({
        "profiled_step": "step fwd+bwd (bench metric), one call under torch.profiler",
        "wall_ms_profiled": st["wall_ms_profiled"],
        "device_busy_ms": st["device_busy_ms"],
        "device_idle_share": st["device_idle_share"],
        "kernel_launches": st["kernel_launches"] if events else "not measured",
        "dense_launches": st["traversal_kernels"]["dense"]["launches"],
        "card": card, "clock": bench.CLOCK[device.type],
    }), flush=True)

    if args.trace is not None:
        logdir = args.trace or os.path.join(tempfile.gettempdir(), "akari-trace")
        with trace(logdir):
            step()
        print(f"trace written to {os.path.join(logdir, 'trace.json')}", flush=True)

    total = rows[0][1]["median_ms"]
    print(f"\n{width}x{height}, {cfg.spp} spp, depth {cfg.max_depth}; n = {n} rays "
          f"[card: {card}]")
    print("| stage | ms (median) | quartiles | % of step |")
    print("|---|---|---|---|")
    for name, s in rows:
        print(f"| {name} | {s['median_ms']:.3f} | {s['q1_ms']:.3f} / {s['q3_ms']:.3f} | "
              f"{100 * s['median_ms'] / total:.0f}% |")
    print(json.dumps({name: round(s["median_ms"], 3) for name, s in rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
