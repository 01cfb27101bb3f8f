"""Render CLI of the port (``akari_tpu/cli/render.py``).

Usage: python -m akari_torch.cli.render -i scene.akari [-o out.png]
       [--spp N] [--max-depth D] [--intersector auto|dense|tree|brute]
       [--width W] [--height H] [--seed S] [--device cuda|cpu] [-v]

``--device`` defaults to ``cuda`` and never falls back: without a CUDA
device, ``--device cuda`` fails with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time


def _logger(verbose):
    log = logging.getLogger("akari_torch")
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
        log.addHandler(h)
    log.setLevel(logging.INFO if verbose else logging.WARNING)
    return log


def main(argv=None):
    ap = argparse.ArgumentParser(prog="akari-render-torch")
    ap.add_argument("-i", "--input", required=True, help="scene .akari file")
    ap.add_argument("-o", "--output", default=None, help="output image path")
    ap.add_argument("--spp", type=int, default=None, help="override spp")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--intersector", default="auto",
                    choices=["auto", "dense", "tree", "brute"])
    ap.add_argument("--width", type=int, default=None,
                    help="override output width (camera resolution)")
    ap.add_argument("--height", type=int, default=None,
                    help="override output height")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    log = _logger(args.verbose)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log.error(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to render on the CPU)"
        )
        return 1

    from ..core.image import write_png
    from ..integrators.path import PathConfig, render
    from ..scene import sdl

    log.info(f"parsing {args.input}")
    try:
        module = sdl.parse_file(args.input)
    except FileNotFoundError:
        log.error(f"scene file not found: {args.input}")
        return 1
    except sdl.SDLError as e:
        log.error(f"parse error: {e}")
        return 1
    scene_node = module.exports.get("scene")
    if scene_node is None:
        log.error("no exported 'scene' found")
        return 1

    t0 = time.perf_counter()
    scene = scene_node.compile(intersector=args.intersector).to(device)
    camera = scene_node.camera
    if args.width or args.height:
        camera = dataclasses.replace(
            camera,
            width=args.width or camera.width,
            height=args.height or camera.height,
        )
    log.info(
        f"scene compiled: {scene.n_tris} tris, {scene.n_materials} materials, "
        f"intersector {scene.intersector} ({time.perf_counter() - t0:.2f}s) on {device}"
    )

    cfg = scene_node.integrator or PathConfig()
    if not isinstance(cfg, PathConfig):
        log.error(f"integrator {type(cfg).__name__} is not supported")
        return 1
    if args.spp:
        cfg = dataclasses.replace(cfg, spp=args.spp)
    if args.max_depth:
        cfg = dataclasses.replace(cfg, max_depth=args.max_depth)
    t0 = time.perf_counter()
    img = render(scene, camera, cfg, seed=args.seed).cpu().numpy()
    dt = time.perf_counter() - t0
    paths = cfg.spp * camera.width * camera.height
    log.info(f"render done took ({dt:.3f}s)  [{paths / dt / 1e6:.2f} Mpaths/s]")

    out = args.output or scene_node.output
    write_png(out, img)
    log.info(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
