"""Find the lanes whose gradient reaches the texel values as NaN.

Runs the bench loss's fwd + bwd on the built-in Cornell box (one trace of
4 folded samples at a time, no remat, so each trace's lanes are known)
with a hook on every row gather of a shading table (``soa.gather_rows_t``)
that requires a gradient, and prints one JSON object: per 4-sample chunk,
the loss and the non-finite texel-gradient entries; and every gather
whose cotangent is non-finite on a row that carries a texel gradient
(closure table: color, alpha, emission, fraction; light table: emission),
with the (pixel, sample) of its first lanes. A lane is reproducible alone
on the CPU: ``trace_paths`` with that pixel and sample index.

Usage: python tools/grad_nan_lanes.py [--res 1024] [--spp 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOSURE_ROWS = [1, 2, 3, 4, 5, 6, 7, 9]   # of the [M, 16] closure table
LIGHT_ROWS = [13, 14, 15]                 # of the [L, 17] light table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=16, help="a multiple of 4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from akari_torch.diff.inverse import apply_params, scene_params
    from akari_torch.integrators import path as path_mod
    from akari_torch.integrators.path import PathConfig
    from akari_torch.scene.builtin import cornell_box
    from akari_torch.shading import soa

    dev = torch.device(args.device)
    sc = cornell_box(args.res, args.res)
    scene = sc.compile(device=dev)
    n = args.res * args.res
    lanes = {}    # the current trace's pixel and sample ids
    found, n_gathers = [], [0]
    real_trace, real_gather = path_mod.trace_paths, soa.gather_rows_t

    def trace(scene_, camera, cfg, seed, sample_idx, pixel_idx, intersectors=None):
        lanes["px"], lanes["smp"] = pixel_idx, sample_idx
        return real_trace(scene_, camera, cfg, seed, sample_idx, pixel_idx, intersectors)

    def gather(table, ids):
        out = real_gather(table, ids)
        if out.requires_grad and ids.numel() == lanes["px"].numel():
            rows = CLOSURE_ROWS if table.shape[1] == 16 else LIGHT_ROWS
            px, smp, call = lanes["px"], lanes["smp"], n_gathers[0]
            n_gathers[0] += 1

            def hook(g):
                bad = ~torch.isfinite(g[rows])
                lane_bad = bad.any(dim=0)
                if bool(lane_bad.any()):
                    first = torch.nonzero(lane_bad)[:8, 0]
                    found.append({
                        "gather": call, "table": list(table.shape),
                        "rows": [rows[int(r)] for r in torch.nonzero(bad.any(dim=1))[:, 0]],
                        "n_lanes": int(lane_bad.sum()),
                        "lanes": [[int(px[i]), int(smp[i])] for i in first],
                    })

            out.register_hook(hook)
        return out

    path_mod.trace_paths, soa.gather_rows_t = trace, gather
    chunks = []
    try:
        for c in range(args.spp // 4):
            p = scene_params(scene)
            p["tex_value"].requires_grad_(True)
            acc = path_mod.trace_accumulate(
                apply_params(scene, p), sc.camera, PathConfig(spp=4, max_depth=5), 0,
                torch.arange(n, device=dev), sample_offset=4 * c)
            loss = (acc ** 2).sum() / (n * 3)
            (g,) = torch.autograd.grad(loss, [p["tex_value"]])
            chunks.append({"samples": [4 * c, 4 * c + 3], "loss": float(loss.detach()),
                           "nonfinite_grad": torch.nonzero(~torch.isfinite(g)).tolist()})
            del acc, loss, g, p
    finally:
        path_mod.trace_paths, soa.gather_rows_t = real_trace, real_gather
    print(json.dumps({"res": args.res, "spp": args.spp, "device": str(dev),
                      "chunks": chunks, "gathers_with_nonfinite_lanes": found}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
