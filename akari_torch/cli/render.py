"""Render CLI of the port (``akari_tpu/cli/render.py``).

Usage: python -m akari_torch.cli.render -i scene.akari [-o out.png]
       [--spp N] [--max-depth D] [--intersector auto|dense|tree|brute]
       [--spectrum-dtype float32|bfloat16] [--width W] [--height H] [--ao]
       [--seed S] [--device cuda|cpu] [--sharded] [--profile] [-v]

The scene's integrator picks the path tracer, ``AO`` or ``BDPT``; ``--ao``
renders ambient occlusion whatever the scene names. ``--spectrum-dtype
bfloat16`` carries the path tracer's radiance and throughput in bfloat16
(``utils/config.py``; AO and BDPT run float32). ``--profile`` prints a
table of the render and image-write spans (``utils/profiler.py``), each
timed to the end of its device work. ``--device`` defaults to ``cuda``
and never falls back: without a CUDA device, ``--device cuda`` fails with
an error.

``--sharded`` renders the path tracer's pixels ray-sharded
(``parallel/render.py``): under ``python -m torch.distributed.run
--nproc-per-node=N``, one rank a process over NCCL on ``cuda`` (a card a
rank, ``cuda:{LOCAL_RANK}``) or gloo on ``cpu``, and rank 0 writes the
image; run directly, one rank a card when ``cuda`` shows more than one
card (spawned by ``parallel/launch.py``, as the reference's mesh spans
every local device), else on a 1-rank mesh. With ``--ao`` or an AO or BDPT
scene, ``--sharded`` is ignored as the reference ignores it: no ray mesh
is made and the frame renders unsharded on ``--device``; under
``torch.distributed.run`` rank 0 alone renders and writes it (the
counterpart of the reference's single process) and the other ranks
return 0.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="akari-render-torch")
    ap.add_argument("-i", "--input", required=True, help="scene .akari file")
    ap.add_argument("-o", "--output", default=None, help="output image path")
    ap.add_argument("--spp", type=int, default=None, help="override spp")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--intersector", default="auto",
                    choices=["auto", "dense", "tree", "brute"])
    ap.add_argument("--spectrum-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="numeric variant of the path tracer's radiance and "
                         "throughput")
    ap.add_argument("--width", type=int, default=None,
                    help="override output width (camera resolution)")
    ap.add_argument("--height", type=int, default=None,
                    help="override output height")
    ap.add_argument("--ao", action="store_true", help="ambient occlusion mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the path tracer's pixels over the ranks of "
                         "torch.distributed.run, or over every card when run "
                         "directly (rank 0 writes the image)")
    ap.add_argument("--profile", action="store_true",
                    help="print a per-span timing table after rendering")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.logger import get_logger, set_verbose

    log = get_logger()
    set_verbose(args.verbose)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log.error(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to render on the CPU)"
        )
        return 1

    from ..integrators.ao import AOConfig
    from ..integrators.bdpt import BDPTConfig
    from ..scene import sdl

    log.info(f"parsing {args.input}")
    t0 = time.perf_counter()
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
    log.info(f"parsed in {time.perf_counter() - t0:.3f}s")
    sharded = args.sharded
    if sharded and (args.ao or isinstance(scene_node.integrator, (AOConfig, BDPTConfig))):
        # the reference takes the AO / BDPT branch before it reads --sharded
        # and renders unsharded; under torch.distributed.run, rank 0 alone
        # renders and writes the image, as the reference's one process does
        sharded = False
        if int(os.environ.get("RANK", "0")) != 0:
            log.info("--sharded ignored for AO / BDPT: rank 0 renders")
            return 0
        log.info("--sharded ignored for AO / BDPT: rendering unsharded")

    mesh = None
    if sharded:
        from ..parallel import launch
        from ..parallel.mesh import initialize_distributed, make_ray_mesh

        ranks = launch.local_ranks(args.device)
        if ranks > 1:
            # run directly on several cards: one rank a card, as the reference's
            # make_ray_mesh() spans every local device; rank 0 writes the image
            log.info(f"--sharded: spawning {ranks} ranks, one a card")
            return max(launch.spawn_ranks(_sharded_rank, ranks, args=(args,),
                                          device=args.device, timeout=float("inf")))
        # torch.distributed.run sets WORLD_SIZE; run directly on one card, one rank
        mesh = (initialize_distributed(args.device) if "WORLD_SIZE" in os.environ
                else make_ray_mesh(args.device))
        device = mesh.device
        log.info(f"ray mesh: rank {mesh.rank} of {mesh.size} on {device}")
    try:
        return _render(args, log, scene_node, device, mesh)
    finally:
        if mesh is not None and mesh.group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _sharded_rank(mesh, args):
    """One spawned rank of ``--sharded``: parse the scene and render this
    rank's share of the pixels on its card (rank 0 writes the image);
    returns the exit code."""
    from ..scene import sdl
    from ..utils.logger import get_logger, set_verbose

    log = get_logger()
    set_verbose(args.verbose)
    scene_node = sdl.parse_file(args.input).exports["scene"]
    return _render(args, log, scene_node, mesh.device, mesh)


def _render(args, log, scene_node, device, mesh):
    """Compile, render and write the image (rank 0 alone on a mesh)."""
    from ..core.image import write_png
    from ..integrators.ao import AOConfig, render_ao
    from ..integrators.bdpt import BDPTConfig, render_bdpt
    from ..integrators.path import PathConfig, render
    from ..utils.config import RGB_BF16, variant_string
    from ..utils.profiler import Profiler

    t0 = time.perf_counter()
    scene = scene_node.compile(intersector=args.intersector, device=device)
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

    prof = Profiler() if args.profile else None

    def frame(name):
        return prof.frame(name) if prof else contextlib.nullcontext()

    cfg = scene_node.integrator or PathConfig()
    if args.spectrum_dtype != "float32" and (
        args.ao or isinstance(cfg, (AOConfig, BDPTConfig))
    ):
        log.warning(
            f"--spectrum-dtype {args.spectrum_dtype} only applies to the "
            "path integrator; the AO/BDPT integrators run float32"
        )
    if args.ao and not isinstance(cfg, AOConfig):
        cfg = AOConfig(spp=args.spp or 16)
    if args.spp:
        cfg = dataclasses.replace(cfg, spp=args.spp)
    t0 = time.perf_counter()
    if isinstance(cfg, AOConfig):
        with frame("render/ao"):
            img = render_ao(scene, camera, cfg, seed=args.seed).cpu().numpy()
    elif isinstance(cfg, BDPTConfig):
        with frame("render/bdpt"):
            img = render_bdpt(scene, camera, cfg, seed=args.seed).cpu().numpy()
    else:
        if args.max_depth:
            cfg = dataclasses.replace(cfg, max_depth=args.max_depth)
        if args.spectrum_dtype != "float32":
            cfg = dataclasses.replace(cfg, dtypes=RGB_BF16)
            log.info(f"variant: {variant_string(cfg.dtypes)}")
        if mesh is not None:
            from ..parallel.render import render_sharded

            with frame("render/path-sharded"):
                img = render_sharded(scene, camera, cfg, mesh, seed=args.seed).cpu().numpy()
        else:
            with frame("render/path"):
                img = render(scene, camera, cfg, seed=args.seed).cpu().numpy()
    dt = time.perf_counter() - t0
    paths = cfg.spp * camera.width * camera.height
    log.info(f"{type(cfg).__name__} render done took ({dt:.3f}s)  "
             f"[{paths / dt / 1e6:.2f} Mpaths/s]")

    if mesh is not None and mesh.rank != 0:
        return 0
    out = args.output or scene_node.output
    with frame("write_image"):
        write_png(out, img)
    log.info(f"wrote {out}")
    if prof:
        prof.print_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
