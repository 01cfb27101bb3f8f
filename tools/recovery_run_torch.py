"""BASELINE config 4 on the port: recover the Cornell box's texture values
(albedo + emitter radiance) with pixel-loss gradients and Adam, 1,000
iterations; with ``--textures``, recover the texels of the textured
Cornell box too.

The settings are those of the JAX package's ``tools/recovery_run.py``:
Cornell 128x128, ``PathConfig(spp=4, max_depth=3)``, every texture value
scaled by 0.4, the target rendered at 16 spp with seed 777, Adam with a
cosine-decayed learning rate from 0.05, an spp ramp 4 -> 16 (iteration
500) -> 32 (iteration 850), EMA(0.98) of the late iterates, parameters in
log space. ``--textures`` runs ``textured_cornell_box`` (every diffuse
albedo one seeded 64x64 checker) with ``optimize_images=True`` and its
texels scaled by 0.4 as well.

Writes ``recovery_torch[_textures].json`` and ``.md`` under ``--out``: the
loss at a matched seed before and after and their ratio, the maximum and
mean relative parameter error over texture values and texels whose true
value is >= 0.05 (for ``--textures`` also of the effective albedo, the
multiplier times the texel, which the loss alone fixes), the wall time
per iteration, the loss every 50 iterations, and the card's name and
power limit.

  python3 tools/recovery_run_torch.py [--textures] [--out chiprun_out]
      [--iterations 1000] [--res 128] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from akari_torch.diff.inverse import InverseConfig, inverse_render
from akari_torch.integrators.path import PathConfig, render
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene.arrays import TEX_IMAGE
from akari_torch.scene.builtin import cornell_box, textured_cornell_box

CORRUPTION = 0.4
SIGNIFICANT = 0.05


def card_line(device):
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)


def rel_errors(rec, true):
    """(max, mean) of |rec - true| / true over entries with true >= 0.05."""
    sig = true >= SIGNIFICANT
    rel = np.abs(rec - true) / np.maximum(true, 1e-6)
    return (float(rel[sig].max()), float(rel[sig].mean())) if sig.any() else (0.0, 0.0)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--textures", action="store_true",
                    help="the textured Cornell box, texels optimized too")
    ap.add_argument("--out", default="chiprun_out", help="report directory")
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("recovery_run_torch: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1

    res, iters = args.res, args.iterations
    sc = (textured_cornell_box if args.textures else cornell_box)(res, res)
    scene = sc.compile(intersector="auto", device=device)
    cam = sc.camera
    cfg = PathConfig(spp=4, max_depth=3, mis=True)
    with torch.no_grad():
        target = render(scene, cam, dataclasses.replace(cfg, spp=16), seed=777)
    tex = scene.textures
    bad_tex = dataclasses.replace(tex, value=tex.value * CORRUPTION)
    if args.textures:
        bad_tex = dataclasses.replace(bad_tex, images=tex.images * CORRUPTION)
    bad = dataclasses.replace(scene, textures=bad_tex)
    with torch.no_grad():
        loss0 = float(loss_and_image(bad, cam, cfg, target, seed=0)[0])

    icfg = InverseConfig(
        iterations=iters, learning_rate=0.05, seed=0, lr_schedule="cosine",
        spp_ramp=((0.5, 16), (0.85, 32)), param_ema=0.98, param_space="log",
        optimize_images=args.textures,
    )
    sync(device)
    t0 = time.perf_counter()
    recovered, losses, _ = inverse_render(bad, cam, cfg, target, icfg)
    sync(device)
    wall = time.perf_counter() - t0
    with torch.no_grad():
        loss_end = float(loss_and_image(recovered, cam, cfg, target, seed=0)[0])

    true_v = tex.value.cpu().numpy()
    rec_v = recovered.textures.value.cpu().numpy()
    report = {
        "mode": "textures" if args.textures else "values",
        "card": card_line(device),
        "res": res, "iterations": iters, "spp": cfg.spp, "max_depth": cfg.max_depth,
        "loss_corrupted": loss0, "loss_recovered": loss_end,
        "loss_ratio": loss_end / loss0,
        "wall_s": wall, "s_per_iteration": wall / iters,
        "value_err_max_mean": rel_errors(rec_v, true_v),
        "losses_every_50": [float(losses[i]) for i in range(0, iters, 50)] + [float(losses[-1])],
        "true_values": true_v.tolist(), "recovered_values": rec_v.tolist(),
    }
    if args.textures:
        sizes = tex.image_sizes.cpu().numpy()
        true_i = tex.images.cpu().numpy()
        rec_i = recovered.textures.images.cpu().numpy()
        mask = np.zeros(true_i.shape[:3], bool)  # the used texels, not the padding
        for i, (h, w) in enumerate(sizes):
            mask[i, :h, :w] = True
        report["texel_err_max_mean"] = rel_errors(rec_i[mask], true_i[mask])
        # effective albedo: the image texture's multiplier times its texels
        img_tex = np.flatnonzero(tex.kind.cpu().numpy() == TEX_IMAGE)
        ids = tex.image_id.cpu().numpy()
        eff_true = np.concatenate([(true_i[ids[k]] * true_v[k])[mask[ids[k]]] for k in img_tex])
        eff_rec = np.concatenate([(rec_i[ids[k]] * rec_v[k])[mask[ids[k]]] for k in img_tex])
        report["albedo_err_max_mean"] = rel_errors(eff_rec, eff_true)
        report["n_texels"] = int(mask.sum())

    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, "recovery_torch" + ("_textures" if args.textures else ""))
    with open(stem + ".json", "w") as f:
        json.dump(report, f, indent=1)
    with open(stem + ".md", "w") as f:
        f.write(f"# Cornell recovery on the port ({report['mode']}), BASELINE config 4\n\n")
        f.write(f"- {res}x{res}, depth 3, MIS; Adam in log space, lr 0.05 cosine, {iters} "
                "iterations, spp ramp 4 -> 16 -> 32, EMA 0.98; values"
                + (" and texels" if args.textures else "") + " scaled by 0.4\n")
        f.write(f"- card: {report['card']}\n")
        f.write(f"- loss (seed 0): {loss0:.6f} -> {loss_end:.6f} "
                f"({report['loss_ratio']:.4f}x)\n")
        mx, mn = report["value_err_max_mean"]
        f.write(f"- texture value error (true >= 0.05): max {100 * mx:.2f} %, "
                f"mean {100 * mn:.2f} %\n")
        if args.textures:
            for key, what in (("texel_err_max_mean", "texel"),
                              ("albedo_err_max_mean", "effective albedo")):
                mx, mn = report[key]
                f.write(f"- {what} error over {report['n_texels']} texels: max "
                        f"{100 * mx:.2f} %, mean {100 * mn:.2f} %\n")
        f.write(f"- wall {wall:.1f} s, {1e3 * wall / iters:.1f} ms per iteration\n\n")
        f.write("## Loss every 50 iterations\n\n```\n")
        for i, l_ in zip(list(range(0, iters, 50)) + [iters - 1], report["losses_every_50"]):
            f.write(f"iter {i:4d}  loss {l_:.6f}\n")
        f.write("```\n")
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("true_values", "recovered_values", "losses_every_50")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
