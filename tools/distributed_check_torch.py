"""Multi-process check of the port's ray-sharded render
(``tools/distributed_check.py`` for ``akari_torch``).

Spawns R ranks (one process each, ``akari_torch.parallel.launch``) that
render two frames with ``render_sharded`` and compares each rank's means
with a 1-rank render of the same frames in this process:

- the 131x131 Cornell path frame (PathConfig(spp=2, max_depth=3)):
  17,161 pixels, not a multiple of R for R in 2..8, so the pad lanes run;
- the 33x33 Cornell BDPT frame (BDPTConfig(spp=1, eye_depth=3,
  light_depth=2)): the whole-film t = 1 splat is summed across the
  ranks, and the pad lanes must not splat.

Both means must agree within a relative 1e-5. ``--device cuda`` puts one
rank on each card over NCCL; with more ranks than cards the ranks share
the cards over gloo (NCCL refuses two ranks on one card), and the JSON
says so. ``--device cpu`` runs the ranks over gloo on the CPU.

Usage: python tools/distributed_check_torch.py [--ranks R] [--device cuda|cpu]
Prints one JSON line like DISTRIBUTED_r05.json; exits non-zero on a
mismatch or a failed rank.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

W = H = 131
BW = BH = 33
REL_TOL = 1e-5


def _frames():
    from akari_torch.integrators.bdpt import BDPTConfig
    from akari_torch.integrators.path import PathConfig
    from akari_torch.scene.builtin import cornell_box

    return [(cornell_box(W, H), PathConfig(spp=2, max_depth=3)),
            (cornell_box(BW, BH), BDPTConfig(spp=1, eye_depth=3, light_depth=2))]


def render_means(mesh):
    """(mean of the path frame, mean of the BDPT frame) on this rank."""
    from akari_torch.parallel import render_sharded

    out = []
    for sc, cfg in _frames():
        scene = sc.compile(intersector="auto", device=mesh.device)
        out.append(float(render_sharded(scene, sc.camera, cfg, mesh, seed=0).double().mean()))
    return out + [mesh.rank, mesh.size, str(mesh.device)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from akari_torch.parallel import make_ray_mesh
    from akari_torch.parallel.launch import rank_route, spawn_ranks

    device, backend, shared = rank_route(args.device, args.ranks)
    golden_pt, golden_bdpt = render_means(make_ray_mesh(device))[:2]
    workers = spawn_ranks(render_means, args.ranks, device=device, backend=backend,
                          timeout=900.0, threads=1 if args.device == "cpu" else None)
    ok, rows = True, []
    for mean_pt, mean_bdpt, rank, size, dev in workers:
        rel_pt = abs(mean_pt - golden_pt) / max(abs(golden_pt), 1e-12)
        rel_bdpt = abs(mean_bdpt - golden_bdpt) / max(abs(golden_bdpt), 1e-12)
        ok &= rel_pt < REL_TOL and rel_bdpt < REL_TOL and size == args.ranks
        rows.append({"rank": rank, "ranks": size, "device": dev, "pixels": W * H,
                     "mean_pt": mean_pt, "rel_err_pt": rel_pt,
                     "mean_bdpt": mean_bdpt, "rel_err_bdpt": rel_bdpt})
    print(json.dumps({
        "ok": ok, "backend": backend,
        "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "ranks_share_one_card": shared,
        "golden_mean_pt": golden_pt, "golden_mean_bdpt": golden_bdpt, "workers": rows,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
