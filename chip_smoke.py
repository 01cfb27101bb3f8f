"""GPU smoke run of the PyTorch / CUDA port (``akari_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each checks its results; any failure exits non-zero):

1. setup: the card's name and power limit; build the CUDA kernels from
   ``akari_torch/kernels/csrc`` and report the build time and the ptxas
   report (registers, stack frame and spills of every kernel summarised);
2. dense kernel vs plain PyTorch version on the card, on >= 2^20 rays
   against the compiled Cornell box and a 300-triangle soup, and on the
   adversarial pack of edge pairs (``adversarial_pack``)
   (prim/valid exact, t/u/v 0 ulp; any-hit == closest-hit validity); then
   bit-equality at ray counts ``RAY_COUNTS`` and triangle counts
   ``TRI_COUNTS``;
3. the main path at the bench width: ``render`` of the 256x256 Cornell
   box, 4 spp, depth 5, with launch counts (1 + max_depth per
   ``trace_paths`` call) and a lit, finite image;
4. cross-framework check: 64x64, 4 spp, depth 5, seed 0 against the
   golden image rendered by the JAX package
   (tests/data/torch_port_cornell64_spp4_d5.npy);
5. realistic size: 1024x1024, 16 spp, depth 5 through ``render`` and
   through the CLI, timed after a warm-up, plus both dense kernels alone
   and their plain versions alone at the fused launch's shape (524,288
   rays): on the rays of the main path's first fused launch, captured from
   a cornell-256 frame (where the kernels are also held against their
   plain versions, 0 ulp), and on the make_rays pack;
6. tree kernel vs plain walk on the card: both variants on >= 2^18 + 77
   rays against the 522,244-triangle terrain (native BVH builder) and a
   20k-triangle soup with exact duplicates across clusters, both on the
   component-major store ``tri_blocks`` (prim/valid exact, t/u/v within 2
   ulp; any-hit == closest validity == the dense plain version's on
   65,536 soup rays);
7. the large-scene main path: ``render`` of ``terrain_scene(256, 256,
   n=512)`` on ``auto``, 4 spp, depth 5, through the tree kernel only
   (1 + max_depth launches per ``trace_paths``, no dense launch), with
   frame time, path and ray rates, peak memory and the host compile time;
8. the 64x64 terrain (7,940 triangles, tree route) against the JAX
   package's golden (tests/data/torch_port_terrain64_spp4_d5.npy);
9. the 2,093,060-triangle terrain on ``auto``, compile time included;
10. the CLI on a large OBJ: the n=512 terrain and its light written as
    OBJ + MTL + .akari, rendered at 256x256, 4 spp;
11. tree kernel and plain walk times at the fused launch's shape (524,288
    rays captured from a render's first bounce), on the rays as the main
    path launches them and sorted by the reference's coherence key, each
    variant's time beside its lower bound;
12. the instanced tree kernel, the flat cluster kernel and the linear
    instanced kernel vs their plain versions on the card, on 2^16 + 77
    rays (camera and seeded random rays, some dead) against
    ``instanced-forest128`` (128 rotated, scaled copies of the 32,258-
    triangle terrain, 4,129,026 world triangles) and the 20k soup with
    its tree nulled, all three on the component-major stores
    (``inst_tri_blocks``, ``tri_blocks``); prim/valid exact, t/u/v 0 ulp,
    any-hit == closest validity; each again on a permuted ray order;
13. ``instanced-forest128`` on ``auto`` (two-level without forcing): 6
    instanced-tree launches per ``trace_paths`` and no other traversal
    launch, frame time, path rate, peak memory, host compile time, a lit
    image;
14. ``instanced-bench64``, the JAX package's recorded instanced workload
    (64 translated terrain copies, no light, forced two-level with
    ``FLATTEN_MAX_TRIS = 1``): frame time, path rate, peak memory;
15. the 64x64 instanced forest (8 copies of the n=16 terrain, two-level)
    against the JAX package's golden
    (tests/data/torch_port_instanced64_spp4_d5.npy);
16. the CLI on an .akari file placing 128 ``Instance`` nodes of a written
    32,258-triangle terrain OBJ plus the light (two-level on ``auto``);
17. the routes of the linear kernels: terrain512 and
    ``instanced-forest128`` with their tree nulled, rendered through
    ``render`` at the cells' width (256x256, 4 spp, depth 5), one frame
    each timed after a warm-up, with launch counts and a lit image; and
    occlusion queries through ``occlude_soa`` on every route (the any-hit
    kernels); each run with the launch counts set to 0 just before it and
    read just after;
18. the instanced tree and linear instanced kernels at the fused launch's
    shape (524,288 rays captured from a frame of ``instanced-forest128``)
    and the flat cluster kernel on phase 11's terrain rays, with their
    plain versions' times and every kernel's lower bound on this card; the
    dense kernels' phase-5 times beside their bounds on both ray sets (the
    bound charges the live rays only, and is logged once more charging
    every ray);
19. the bench step (the JAX package's ``bench.py:43-91``): the Cornell
    box at 256x256, 4 spp, depth 5, NEE + MIS, the mean-squared pixel loss
    against a zero target and its gradient with respect to the texel
    values (``loss_and_image``, ``scene_params``): finite, nonzero on the
    emitter texel, 6 dense closest-hit launches a step and none in the
    backward, the same step through the plain intersector on the card
    (bit-equal loss, gradient within ``GRAD_TOL``); step and forward times
    (quartiles of 10 after 2 warm-ups, CUDA events), the bench's ray rate,
    peak memory, the CUDA launches of the forward and of the backward and
    the backward's time in ``index_add`` (the row gathers' backward);
20. the 64x64 step against the JAX package's loss and gradient
    (tests/data/torch_port_grad_cornell64_spp4_d5.npz);
21. ``PathConfig.remat``: at 256x256 the same loss, the gradient within
    ``GRAD_TOL``, no intersection launch in the backward, both peak
    memories; then 1024x1024, 16 spp, depth 5 fwd + bwd under remat: step
    time, peak memory (below the card's 80 GB), a finite gradient;
22. the boundary term on tests/test_boundary.py's shadow scene (24x24,
    rebuilt from the port's nodes): the ``tri_delta`` gradient of the
    render plus ``boundary_direct_term``, kernel route against the plain
    route, the dense any-hit launches of its side probes, the time of one
    evaluation;
23. the trainer: ``inverse_render`` for 20 iterations at 64x64 from the
    walls' albedo at 0.4x; the loss at a fixed evaluation seed falls below
    half its start; time per iteration;
24. the env-lit textured OBJ through the CLI (BASELINE.json config 3):
    ``write_envtex_terrain`` writes the n=256 terrain (130,050 triangles)
    as OBJ with planar texture coordinates, an MTL whose ``map_Kd`` names a
    2048^2 seeded PNG (its rows filtered as other encoders filter them,
    mostly Average), its area light and ``EnvMap { image: "sky.hdr" }``
    (a seeded 1024 x 2048 RGBE sky); parse (with the PNG decode alone),
    compile, one timed 256^2 x 16 spp depth-5 frame on ``auto`` (tree
    closest launches only), path and ray rates, peak memory, a lit image;
    that frame's first fused launch (bounce rays with the env and area
    shadow rays) through the tree kernels and their plain versions; then
    the CLI on the same files (the same launches, a lit PNG);
25. the n=64 env-lit textured terrain at 64x64 against the JAX package's
    golden (tests/data/torch_port_envtex64_spp4_d5.npy);
26. BDPT at full width (BASELINE.json config 5): ``render_bdpt`` on phase
    9's 2,093,060-triangle terrain (its host compile copied to the card
    again), ``BDPTConfig(spp=64)``, timed after a 1-spp warm-up: 6 tree
    closest and 1 tree any-hit launches per sample, the any-hit launch's
    983,040 queued connection rays, rates, peak memory, a lit image; the
    first sample's connection group through the tree kernels and their
    plain versions;
27. AO on the same terrain: ``render_ao`` at ``AOConfig`` defaults (16
    spp) timed; one sample's camera and occlusion rays through the tree
    kernels and their plain versions; then the CLI ``--ao`` on the
    terrain written as OBJ + MTL + .akari (one tree closest and one tree
    any-hit launch per sample);
28. BDPT on the 64x64 Cornell box at 4 spp and AO on the n=64 terrain at
    64x64 against the JAX package's goldens; the BDPT render through the
    dense kernels and through their plain versions on the card (radiance
    bit-equal, the splat film within ``SPLAT_TOL``); one env-lit
    ``instanced-forest128`` frame (instanced tree launches only, lit);
29. the result: a JSON line of kernel records (the dense records on the
    captured fused rays; the any-hit records count phase 17's queries,
    phase 22's side probes and the BDPT and AO launches of phases 26-28;
    the tree records' errors cover phases 6, 24, 26 and 27), then the
    device line.

Each phase of the new paths (3, 7, 10, 13, 16, 17, 24, 26-28) sets the
kernels' launch counts to 0 just before its run and reads them just after.

Every kernel source (and the native BVH builder) is built at start, one
compiler process each, all started together. Imports nothing of JAX.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_cornell64_spp4_d5.npy")
TERRAIN_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_terrain64_spp4_d5.npy")
INSTANCED_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_instanced64_spp4_d5.npy")
GRAD_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_grad_cornell64_spp4_d5.npz")
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")

N_RAYS = (1 << 20) + 77          # not a multiple of any block size
TREE_RAYS = (1 << 18) + 77       # tree kernel vs plain walk
SOUP_SUBSET = 65_536             # tree vs dense plain version on the soup
FUSED_RAYS = 2 * 256 * 256 * 4   # shadow + extension rays of one bounce
MEAN_LIT_MIN = 0.05              # "clearly lit" bound on the mean radiance
INST_RAYS = (1 << 16) + 77       # instanced and linear kernels vs plain
PLAIN_SUBSET = 1 << 16           # plain timing subset when a full call is slow
PLAIN_FULL_MAX_S = 10.0          # ... that is, slower than this
SLEEP_CYCLES = 50_000_000        # ~25 ms of device clock: the host enqueues meanwhile
KERNELS = ("dense_intersect", "tree_intersect", "instanced_tree_intersect",
           "cluster_intersect")
FOREST_SDL_ROTATION = (-23.4805, 33.6901, 0.0)  # look_at((6, 5, 9), (0, 0.3, 0)), ZYX degrees

# Lower bound of a kernel on this card: the larger of its float operations
# over the H100's f32 rate outside the tensor cores and its bytes (rays
# read once, hits written once, each table row it needs read once) over
# the HBM rate (NVIDIA's H100 SXM data sheet, at the 700 W limit).
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SLAB_OPS = 24     # one ray-box slab test: 6 sub, 6 mul, 10 min/max, 2 compares
MT_OPS = 55       # one Moller-Trumbore test: 2 cross, 4 dot, the reciprocal, 8 compares
RAY_BYTES, CLOSEST_BYTES, ANY_HIT_BYTES = 32, 16, 1
ROW_BYTES = {"nodes": 64, "tri_blocks": 36, "instances": 112, "supers": 32, "clusters": 32}
RAY_COUNTS = (1, 31, 33, 255, 257, 513, 5000)        # not multiples of any block's rays
# Gradients through the kernel route against the plain route (and between
# two runs): the hits are bit-equal, but the backward of every row gather
# is a scatter-add of 262,144 lanes into a few table rows by atomics, whose
# order, and so whose rounding, changes from run to run. Bound on
# max|g - g_plain| / max|g_plain| (measured on an NVIDIA H100 80GB HBM3: at
# most 5.4e-6 for kernel vs plain, run to run, remat and the boundary term).
GRAD_TOL = 3e-5
# Phase 20, the card's gradient against the JAX package's on the CPU:
# |loss - loss_jax| / loss_jax and max|g - g_jax| / max|g_jax| (measured on
# an NVIDIA H100 80GB HBM3: 1.5e-7 and at most 9.1e-7).
GOLDEN_LOSS_RTOL = 1e-6
GOLDEN_GRAD_TOL = 1e-5
CARD_BYTES = 80e9                # the H100's device memory
# Phase 28, render_bdpt through the kernels against their plain versions:
# the radiance is bit-equal (the hits are); the splat film's index_add
# atomics sum in a run-dependent order. Bound on max|splat - splat_plain|
# / max|image|, set before the first measurement on the card.
SPLAT_TOL = 1e-5
# The env-lit textured terrain (BASELINE.json config 3) written by
# akari_torch.scene.builtin.write_envtex_terrain, and its 64x64 golden's
# arguments (tools/make_torch_port_envtex_golden.py)
ENVTEX_FULL = dict(n=256, res=256, spp=16, depth=5, tex_res=2048, sky_hw=(1024, 2048))
ENVTEX_GOLDEN_SCENE = dict(n=64, res=64, spp=4, depth=5, tex_res=64, sky_hw=(64, 128))
ENVTEX_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_envtex64_spp4_d5.npy")
BDPT_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_bdpt_cornell64_spp4.npy")
AO_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_ao_terrain64_spp16.npy")
BDPT_SPP = 64                    # BASELINE.json config 5
TRI_COUNTS = (1, 35, 36, 37, 255, 256, 257, 4096)    # across the chunk and DENSE_MAX_TRIS


def log(msg):
    print(msg, flush=True)


def store_mb(x):
    return f"{x.numel() * x.element_size() / 1e6:.1f} MB {tuple(x.shape)}"


def ptxas_summary(report):
    """The lines of a ptxas -v report that give each kernel's registers,
    stack frame and spills."""
    keep = ("Compiling entry", "bytes stack frame", "Used ")
    return "\n".join(line.strip() for line in report.splitlines() if any(k in line for k in keep))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    """Fail the run (an exception, so it holds under python -O too)."""
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a, b):
    """Max ulp distance between two float32 tensors over unequal lanes
    (-0.0 == 0.0 counts as equal)."""
    import torch

    neq = a != b
    if not bool(neq.any()):
        return 0
    ia = a[neq].contiguous().view(torch.int32).to(torch.int64)
    ib = b[neq].contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds per call of fn() on the current stream, run back
    to back. A sleep kernel queued before the start event lets the host
    enqueue the calls before the card reaches them, so the host's time per
    call (argument checks, output allocation, the ctypes call) opens no
    gap between launches: it would for a kernel of tens of microseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def images_match(a, b, rtol=1e-3, atol=2e-3, outlier_frac=0.08, mean_tol=3e-3):
    """The outlier-budget image comparison of tests/_imgcmp.py."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    check(a.shape == b.shape, f"shapes {a.shape} != {b.shape}")
    d = np.abs(a - b)
    frac = float((d > (atol + rtol * np.abs(b))).mean())
    mean = float(d.mean())
    log(f"  outlier frac {frac:.5f} (budget {outlier_frac}), "
        f"mean abs diff {mean:.3e} (budget {mean_tol}), max {d.max():.4g}")
    check(frac <= outlier_frac, f"outlier fraction {frac} > {outlier_frac}")
    check(mean <= mean_tol, f"mean abs diff {mean} > {mean_tol}")


def compare_kernel(name, rays, mod, args, n_tris, closest="closest", any_hit="any_hit",
                   max_ulp_allowed=2):
    """Kernel vs plain on the card for a kernel module with the
    ``closest``/``closest_plain``/``any_hit``/``any_hit_plain`` API (or
    the variants named) and table arguments ``args``; returns the max
    |difference| of the closest-hit outputs and of the any-hit flags, and
    the kernel's closest-hit outputs."""
    import torch

    t0 = time.perf_counter()
    t_k, u_k, v_k, p_k = getattr(mod, closest)(rays, *args)
    occ_k = getattr(mod, any_hit)(rays, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    t_p, u_p, v_p, p_p = getattr(mod, closest + "_plain")(rays, *args)
    occ_p = getattr(mod, any_hit + "_plain")(rays, *args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.equal(p_k, p_p), f"{name}: prim differs on {int((p_k != p_p).sum())} rays")
    valid = p_k >= 0
    errs, ulps = [], []
    for a, b in ((t_k, t_p), (u_k, u_p), (v_k, v_p)):
        errs.append(float((a - b).abs().max()))
        ulps.append(ulp_diff(a[valid], b[valid]))
    max_err, max_ulp = max(errs), max(ulps)
    check(max_ulp <= max_ulp_allowed, f"{name}: t/u/v differ by {max_ulp} ulp")
    check(torch.equal(occ_k, occ_p), f"{name}: any-hit kernel != plain")
    check(torch.equal(occ_k, valid), f"{name}: any-hit != closest.valid")
    occ_err = float((occ_k.float() - occ_p.float()).abs().max())
    n_dead = int((rays[7] <= rays[6]).sum())
    log(f"  {name}: {rays.shape[1]} rays ({n_dead} dead) x {n_tris} "
        f"tris, {int(valid.sum())} hits, prim/valid exact, t/u/v max |diff| {max_err:.3g} "
        f"({max_ulp} ulp), any-hit == closest.valid == plain; kernels {t1 - t0:.3f} s, "
        f"plain {t2 - t1:.3f} s (wall)")
    return max_err, occ_err, (t_k, u_k, v_k, p_k)


def check_permuted(name, rays, mod, args, hit, closest="closest", any_hit="any_hit"):
    """The kernels on a permuted ray order give each ray the answer it got
    in order (``hit``: the closest-hit outputs in order)."""
    import torch

    g = torch.Generator(device=rays.device).manual_seed(5)
    perm = torch.randperm(rays.shape[1], generator=g, device=rays.device)
    rp = rays[:, perm].contiguous()
    check(all(torch.equal(a, b[perm]) for a, b in zip(getattr(mod, closest)(rp, *args), hit)),
          f"{name}: a ray's answer depends on its neighbours")
    check(torch.equal(getattr(mod, any_hit)(rp, *args), hit[3][perm] >= 0),
          f"{name} any-hit: a ray's answer depends on its neighbours")
    log(f"  {name} on a permuted ray order: every ray's answer unchanged")


@contextlib.contextmanager
def kept_call(mod, names, keep=0):
    """Wrap ``mod.<name>`` for each of ``names``: every call goes through;
    ``calls.sizes[name]`` lists each call's ray count and
    ``calls.kept[name]`` holds call number ``keep``'s (rays, tables), so a
    path's own rays can be held against the plain version afterwards."""
    real = {n: getattr(mod, n) for n in names}
    calls = SimpleNamespace(sizes={n: [] for n in names}, kept={})

    def wrap(n):
        def fn(rays, *args):
            if len(calls.sizes[n]) == keep:
                calls.kept[n] = (rays, args)
            calls.sizes[n].append(rays.shape[1])
            return real[n](rays, *args)
        return fn

    for n in names:
        setattr(mod, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(mod, n, real[n])


def tree_soup(dev, torch, n=20_000, seed=7):
    """20k random triangles in [-1, 1]^3, sorted along a Morton curve so
    clusters are compact, with exact duplicates copied into far clusters
    (they pin the lowest-index tie rule); returns ([n, 9] triangles, tree
    args: nodes, the component-major store, n, leaf span) on the card."""
    import numpy as np

    from akari_torch.bvh import cluster_tree as ct

    r = np.random.default_rng(seed)
    v0 = r.uniform(-1.0, 1.0, size=(n, 3))
    q = np.clip(((v0 + 1.0) * 512).astype(np.int64), 0, 1023)
    code = np.zeros(n, np.int64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    v0 = v0[np.argsort(code, kind="stable")]
    e = r.normal(scale=0.06, size=(n, 6))
    tris = np.concatenate([v0, e], axis=1).astype(np.float32)
    tris[15000:15128] = tris[100:228]    # a whole cluster's worth, far away
    tris[4000:4040] = tris[19000:19040]  # duplicates of later triangles
    clusters = ct.build_clusters(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])
    nodes, span = ct.build_cluster_tree(clusters, n)
    blocks = ct.tri_blocks(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])
    return (torch.from_numpy(tris).to(dev),
            (torch.from_numpy(nodes).to(dev), torch.from_numpy(blocks).to(dev), n, span))


def png_pixels(path):
    """[H, W, 3] uint8 of a PNG the CLI wrote, through the port's decoder
    (tests/test_torch_textures.py holds it to PIL on every filter type)."""
    from akari_torch.core.image import decode_png

    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def write_terrain_obj(directory, scene_node, res, spp, depth):
    """The terrain scene's meshes as OBJ + MTL and an .akari file that
    renders them; returns the .akari path."""
    import numpy as np

    terrain, light = scene_node.shapes
    obj = os.path.join(directory, "terrain.obj")
    with open(os.path.join(directory, "terrain.mtl"), "w") as f:
        f.write("newmtl ground\nKd 0.73 0.71 0.68\n"
                "newmtl light\nKd 0 0 0\nKe 14 13 11\n")
    nv = terrain.vertices.shape[0]
    with open(obj, "w") as f:
        f.write("mtllib terrain.mtl\n")
        np.savetxt(f, terrain.vertices, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, light.vertices, fmt="v %.9g %.9g %.9g")
        f.write("usemtl ground\n")
        np.savetxt(f, terrain.indices + 1, fmt="f %d %d %d")
        f.write("usemtl light\n")
        np.savetxt(f, light.indices + 1 + nv, fmt="f %d %d %d")
    akari = os.path.join(directory, "terrain.akari")
    with open(akari, "w") as f:
        f.write(
            "export camera = PerspectiveCamera {\n"
            "    fov: 45, position: [0, 2.2, 2.2], rotation: [-40, 0, 0],\n"
            f"    resolution: [{res}, {res}]\n}}\n"
            'export mesh = AkariMesh { path: "terrain.obj" }\n'
            "export scene = Scene {\n"
            "    camera: $camera,\n"
            f"    integrator: Path {{ spp: {spp}, max_depth: {depth} }},\n"
            '    output: "terrain.png",\n'
            "    shapes: [ $mesh ]\n}\n"
        )
    return akari


def render_frame(render, scene, camera, cfg, torch):
    """One warm-up render, then one timed render: (image, ms by CUDA
    events, wall s, peak GiB)."""
    render(scene, camera, cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    t0 = time.perf_counter()
    ms = cuda_ms(lambda: out.append(render(scene, camera, cfg, seed=0)), iters=1, warmup=0)
    wall = time.perf_counter() - t0
    return out[0], ms, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def frame_line(label, ms, wall, peak, res, cfg, card):
    paths = res * res * cfg.spp
    rays_total = paths * (2 * cfg.max_depth + 1)
    log(f"  {label}: {ms / 1e3:.4f} s/frame (CUDA events), {wall:.4f} s wall, "
        f"{paths / (ms / 1e3) / 1e6:.2f} Mpaths/s, "
        f"{rays_total / (ms / 1e3) / 1e6:.1f} M rays/s, peak {peak:.2f} GiB [card: {card}]")


def compile_timed(scene_node, dev, torch, host=None):
    """Compile on the host and move to the card; (scene, description of
    the host seconds: BVH build, clusters + tree, the rest, the copy).
    ``host``, a list, receives the host (CPU) scene for a later copy."""
    t0 = time.perf_counter()
    scene = scene_node.compile(intersector="auto")
    if host is not None:
        host.append(scene)
    secs = scene.compile_seconds
    t1 = time.perf_counter()
    scene = scene.to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rest = secs["total"] - secs["bvh"] - secs["tree"]
    return scene, (
        f"host compile {t1 - t0:.2f} s (BVH build {secs['bvh']:.2f} s, clusters + tree "
        f"{secs['tree']:.2f} s, rest {rest:.2f} s, outside compile_scene "
        f"{t1 - t0 - secs['total']:.2f} s), copy to the card {t2 - t1:.2f} s"
    )


def check_image(img, res, label):
    import numpy as np

    check(img.shape == (res, res, 3), f"{label}: image shape {img.shape}")
    check(bool(np.all(np.isfinite(img))), f"{label}: non-finite radiance")
    mean = float(img.mean())
    log(f"  {label}: image mean {mean:.5f} (> {MEAN_LIT_MIN})")
    check(mean > MEAN_LIT_MIN, f"{label}: image too dark: mean {mean}")


def make_rays(scene, camera, n, seed, torch, box=((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95)),
              hit_t=None):
    """Primary rays, random rays with origins in ``box``, bounded t_max
    (half the ray's own hit distance from ``hit_t``, by default the dense
    plain version), dead rays (t_max = 0): an [8, n] pack."""
    from akari_torch.core.v3 import V3
    from akari_torch.integrators.path import camera_rays_soa
    from akari_torch.ops import dense_intersect as di

    if hit_t is None:
        hit_t = lambda r: di.closest_plain(r, scene.prim_table)[0]  # noqa: E731
    dev = scene.device
    n_prim = min(n // 4, camera.width * camera.height * 4)
    pix = torch.arange(n_prim, device=dev, dtype=torch.int64) % (camera.width * camera.height)
    smp = torch.div(torch.arange(n_prim, device=dev), camera.width * camera.height,
                    rounding_mode="floor")
    o1, d1 = camera_rays_soa(camera, seed, smp, pix)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = n - n_prim
    lo = torch.tensor(box[0], device=dev)
    hi = torch.tensor(box[1], device=dev)
    o2 = lo + (hi - lo) * torch.rand((m, 3), generator=g, device=dev)
    d2 = torch.randn((m, 3), generator=g, device=dev)
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    o = V3(*(torch.cat([a, o2[:, k]]) for k, a in enumerate(o1)))
    d = V3(*(torch.cat([a, d2[:, k]]) for k, a in enumerate(d1)))
    zero = torch.zeros(n, device=dev)
    tmax = torch.full((n,), di.T_MAX, device=dev)
    rays = di.pack_rays(o, d, zero, tmax).contiguous()
    t_hit = hit_t(rays)
    sel = torch.randint(0, 3, (n,), generator=g, device=dev)
    rays[7] = torch.where(sel == 0, t_hit * 0.5, torch.where(sel == 1, 0.0, tmax))
    return rays


def adversarial_pack(dev, torch, seed=0):
    """Rays and triangles whose pairs sit on the edges of the dense
    kernel's hit test and of float32: an ([8, N] rays, [T, 9] triangles)
    pair on ``dev``.

    Special triangle k is v0 = 0, e1 = (0, D_k, 0), e2 = (1, 0, 0); with a
    ray of direction (0, 0, 1) that gives det = D_k, u_num = oy and
    v_num = RN(ox D_k) exactly (pvec = (0, 1, 0)) and t close to -oz. D_k
    runs over HIT_EPS and 2^60 with one ulp either side, both signs, +-0,
    +-inf and NaN; the rays put u_num and v_num on 0, -0, denormals, 2^-60
    with one ulp either side, +-inf and NaN, and (u, v) on the edges (u or
    v exactly 0, u + v exactly 1, just outside). Seeded random rays and
    triangles (with exact duplicates: ties go to the lower index) join
    them, so every special ray also meets generic triangles and back."""
    import numpy as np

    f32 = np.float32
    inf, nan = np.inf, np.nan

    def around(x):  # x and one ulp either side
        x = f32(x)
        return [np.nextafter(x, f32(-inf)), x, np.nextafter(x, f32(inf))]

    eps, big = around(1e-9), around(2.0 ** 60)
    tuned = [1.0, -1.0, 0.5, *eps, *(-e for e in eps), *big, *(-b for b in big)]
    dets = tuned + [3.0, 2.0 ** -20, 0.0, -0.0, inf, -inf, nan]
    special = np.zeros((len(dets), 9), np.float32)
    special[:, 4] = dets
    special[:, 6] = 1.0
    bary = [(0.0, 0.0), (-0.0, 0.25), (0.25, -0.0), (0.25, 0.75), (0.75, 0.25), (1.0, 0.0),
            (0.0, 1.0), (0.5, 0.5), (0.375, 0.625), (-1e-7, 0.5), (0.5, -1e-7),
            (-1e-30, 0.5), (0.5, -1e-30), (0.5, 0.5 + 1e-7)]
    xy = [(f32(vt / dk), f32(ut * dk)) for dk in tuned for ut, vt in bary]
    nums = [0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, *around(2.0 ** -60),
            *(-x for x in around(2.0 ** -60)), 0.25, -0.25, 1e20, -1e20, inf, -inf, nan]
    for x in nums:
        xy += [(0.25, x), (-0.25, x), (0.0, x), (x, 0.25), (x, -0.25)]
    xy += [(x, 0.25) for x in around(2.0 ** -120)]  # v_num at 2^-60 against D = 2^60
    ox, oy = (np.asarray(c, np.float64) for c in zip(*xy))
    m = len(xy)
    o = np.stack([ox, oy, np.full(m, -1.0)], axis=1)
    o[::11, 2] = 1.0     # behind the ray: t < 0
    o[5::11, 2] = -0.0   # t = 0 at t_min = 0
    d = np.tile([0.0, 0.0, 1.0], (m, 1))
    d[3::29] = [nan, 0.0, 1.0]
    d[7::29] = [inf, 0.0, 1.0]
    d[13::29] = [0.0, 0.0, -0.0]
    r = np.random.default_rng(seed)
    limits = np.asarray([(0.0, 1e30), (0.0, 1e30), (0.0, 1e30), (0.0, 2.0), (0.0, 0.5),
                         (-0.0, 1e30), (0.5, 1e30), (1.0, 1e30), (nan, 1e30), (0.0, nan),
                         (0.0, 0.0), (1.0, 1.0)])
    lim = limits[r.integers(0, len(limits), m)]
    # generic rays from inside [-1, 1]^3, a seventh of them dead
    g = 256
    go = r.uniform(-1.0, 1.0, (g, 3))
    gd = r.normal(size=(g, 3))
    gd /= np.linalg.norm(gd, axis=1, keepdims=True)
    glim = np.stack([np.zeros(g), np.where(np.arange(g) % 7 == 0, 0.0, 1e30)], axis=1)
    rays = np.concatenate([np.concatenate([o, d, lim], axis=1),
                           np.concatenate([go, gd, glim], axis=1)]).T
    generic = np.concatenate([r.uniform(-1.0, 1.0, (64, 3)), r.normal(scale=0.6, size=(64, 6))],
                             axis=1)
    generic[40:52] = generic[4:16]  # exact duplicates
    tris = np.concatenate([special, generic]).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(rays, np.float32)).to(dev),
            torch.from_numpy(tris).to(dev))


@contextlib.contextmanager
def flatten_max_tris(n):
    """Compile instanced scenes two-level above ``n`` world triangles (the
    module constant, as the JAX package's bench forces it)."""
    import akari_torch.scene.nodes as nodes

    old = nodes.FLATTEN_MAX_TRIS
    nodes.FLATTEN_MAX_TRIS = n
    try:
        yield
    finally:
        nodes.FLATTEN_MAX_TRIS = old


def reset_all(mods):
    for m in mods:
        m.reset_launches()


def others(mods, *skip):
    """Launches of the traversal kernels outside ``skip``."""
    return sum(sum(m.LAUNCHES.values()) for m in mods if m not in skip)


def bound_ms(ops, nbytes):
    """(least ms on the card, "operations" or "bytes")."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def walk_bound(stats, n_rays, any_hit):
    """Bound of a traversal kernel from the work its plain version counted
    on the same rays (``WalkStats``): slab tests, Moller-Trumbore tests,
    instance transforms, and each distinct table row read once."""
    from akari_torch.ops.instanced_tree_intersect import XFORM_OPS

    ops = stats.slab * SLAB_OPS + stats.mt * MT_OPS + stats.xform * XFORM_OPS
    nbytes = n_rays * (RAY_BYTES + (ANY_HIT_BYTES if any_hit else CLOSEST_BYTES))
    nbytes += sum(ROW_BYTES[k] * stats.distinct(k) for k in stats.rows)
    return bound_ms(ops, nbytes)


def dense_bound(rays, tris, any_hit, live_only=True):
    """Bound of the dense kernel: each live ray (t_min < best_t, the only
    rays that can hit) tests every triangle (closest), or the triangles up
    to its first hit in index order (any hit); every ray is read once and
    every answer written once. ``live_only=False`` charges every ray's
    tests, dead ones included (phase 18 logs it beside for comparison)."""
    import torch

    from akari_torch.ops import dense_intersect as di

    n, n_tris = rays.shape[1], tris.shape[0]
    best = rays[7] if any_hit else torch.clamp(rays[7], max=di.T_MAX)
    live = (rays[6] < best) if live_only else torch.ones_like(best, dtype=torch.bool)
    if any_hit:
        tests = 0
        step = max(1, di.PLAIN_PAIRS_PER_CHUNK // n_tris)
        for s in range(0, n, step):
            r = rays[:, s:s + step]
            hit = di._pairwise_mt(r, tris, r[7])[0]
            first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1, n_tris)
            tests += int(first[live[s:s + step]].sum())
    else:
        tests = int(live.sum()) * n_tris
    nbytes = n * (RAY_BYTES + (ANY_HIT_BYTES if any_hit else CLOSEST_BYTES))
    return bound_ms(tests * MT_OPS, nbytes + tris.numel() * 4)


def plain_figures(plain, rays, any_hit, card):
    """Count the plain version's work on the fused rays (untimed, for the
    bound), then time it: on all the rays if the counting call took under
    PLAIN_FULL_MAX_S, else on the first PLAIN_SUBSET. Returns (bound ms,
    bound_by, plain ms, rays the plain time is for)."""
    import torch

    from akari_torch.ops.tree_intersect import WalkStats

    stats = WalkStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(rays, stats=stats)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    b_ms, b_by = walk_bound(stats, rays.shape[1], any_hit)
    sub = rays if count_s < PLAIN_FULL_MAX_S else rays[:, :PLAIN_SUBSET].contiguous()
    p_ms = cuda_ms(lambda: plain(sub), iters=1, warmup=0)
    log(f"    plain work: {stats.slab} slab tests, {stats.mt} MT tests, {stats.xform} "
        f"transforms, distinct rows { {k: stats.distinct(k) for k in stats.rows} } "
        f"(counted in {count_s:.1f} s); bound {b_ms:.4f} ms ({b_by}); plain "
        f"{p_ms:.4f} ms on {sub.shape[1]} rays [card: {card}]")
    return b_ms, b_by, p_ms, sub.shape[1]


def capture_fused(mod, name, render_fn, n_rays=FUSED_RAYS):
    """The rays of the first launch of ``mod.<name>`` at the fused shape
    (``n_rays`` rays) during ``render_fn()``."""
    captured = []
    real = getattr(mod, name)

    def capture(rays_, *args_):  # keeps the first fused launch's rays
        if not captured and rays_.shape[1] == n_rays:
            captured.append(rays_.clone())
        return real(rays_, *args_)

    setattr(mod, name, capture)
    try:
        render_fn()
    finally:
        setattr(mod, name, real)
    check(len(captured) == 1, f"no fused {name} launch of the expected shape was seen")
    return captured[0]


def write_forest_sdl(directory, res, spp, depth):
    """The 32,258-triangle terrain prototype and the forest's light as OBJ
    + MTL, and an .akari file placing 128 Instance nodes of it at the
    forest's transforms; returns the .akari path."""
    import numpy as np

    from akari_torch.scene.builtin import forest_transforms, terrain_mesh

    proto = terrain_mesh(128)
    with open(os.path.join(directory, "forest.mtl"), "w") as f:
        f.write("newmtl ground\nKd 0.73 0.71 0.68\n"
                "newmtl light\nKd 0 0 0\nKe 14 13 11\n")
    with open(os.path.join(directory, "terrain.obj"), "w") as f:
        f.write("mtllib forest.mtl\n")
        np.savetxt(f, proto.vertices, fmt="v %.9g %.9g %.9g")
        f.write("usemtl ground\n")
        np.savetxt(f, proto.indices + 1, fmt="f %d %d %d")
    with open(os.path.join(directory, "light.obj"), "w") as f:
        f.write("mtllib forest.mtl\nv -2 4 2\nv -2 4 -2\nv 2 4 -2\nv 2 4 2\n"
                "usemtl light\nf 1 2 3\nf 1 3 4\n")
    placements = ",\n".join(
        "        Instance { mesh: $terrain, transform: ["
        + ", ".join(f"{x:.9g}" for x in m.reshape(-1)) + "] }"
        for m in forest_transforms(128)
    )
    akari = os.path.join(directory, "forest.akari")
    rx, ry, rz = FOREST_SDL_ROTATION
    with open(akari, "w") as f:
        f.write(
            "export camera = PerspectiveCamera {\n"
            f"    fov: 40, position: [6, 5, 9], rotation: [{rx}, {ry}, {rz}],\n"
            f"    resolution: [{res}, {res}]\n}}\n"
            'export terrain = AkariMesh { path: "terrain.obj" }\n'
            'export light = AkariMesh { path: "light.obj" }\n'
            "export scene = Scene {\n"
            "    camera: $camera,\n"
            f"    integrator: Path {{ spp: {spp}, max_depth: {depth} }},\n"
            '    output: "forest.png",\n'
            f"    shapes: [\n{placements},\n        $light\n    ]\n}}\n"
        )
    return akari


def emissive_texels(scene):
    """Bool [X] on the scene's device: texels that color an emissive
    material."""
    import torch

    from akari_torch.scene.arrays import MAT_EMISSIVE

    m = scene.materials
    em = torch.zeros(scene.textures.value.shape[0], dtype=torch.bool, device=scene.device)
    em[m.color_tex[m.kind == MAT_EMISSIVE].long()] = True
    return em


def bench_step(scene, camera, cfg, target, seed=0):
    """One fwd + bwd step of the bench loss: (loss, d loss / d tex_value)."""
    import torch

    from akari_torch.diff.inverse import apply_params, scene_params
    from akari_torch.parallel.render import loss_and_image

    p = scene_params(scene)
    p["tex_value"].requires_grad_(True)
    loss, _ = loss_and_image(apply_params(scene, p), camera, cfg, target, seed=seed)
    (g,) = torch.autograd.grad(loss, [p["tex_value"]])
    return loss.detach(), g


@contextlib.contextmanager
def plain_route(mod):
    """The module's closest and any-hit kernels replaced by their plain
    versions (which run on the card too, without counting launches)."""
    saved = {n: getattr(mod, n) for n in ("closest", "any_hit")}
    for n in saved:
        setattr(mod, n, getattr(mod, n + "_plain"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(mod, n, f)


def event_quartiles(fn, iters=10, warmup=2):
    """(25th, 50th, 75th percentile) ms of fn() over ``iters`` runs after
    ``warmup``, each between two CUDA events on an idle card (host
    dispatch included: these steps are host-bound)."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return tuple(float(x) for x in np.percentile(times, [25, 50, 75]))


def device_events(fn):
    """Run fn() under torch.profiler: (its CUDA activity events: kernels,
    copies and sets, each a launch, fn's result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA], out


def shadow_scene(w, h):
    """tests/test_boundary.py's shadow scene from the port's nodes: a
    diffuse floor, a small occluder quad outside the frustum and an area
    light above it; the camera looks straight down at the shadow."""
    import numpy as np

    from akari_torch.core import transform as xform
    from akari_torch.scene.arrays import make_camera
    from akari_torch.scene.nodes import DiffuseMaterial, EmissiveMaterial, Mesh, Scene

    def quad(center, half, axis_u, axis_v, mat):
        c = np.asarray(center, np.float32)
        u = np.asarray(axis_u, np.float32) * half
        v = np.asarray(axis_v, np.float32) * half
        verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
        return Mesh(vertices=verts, indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                    materials=[mat])

    floor = quad((0, 0, 0), 4.0, (1, 0, 0), (0, 0, -1), DiffuseMaterial((0.8,) * 3))
    occ = quad((0.6, 1.0, 0), 0.15, (1, 0, 0), (0, 0, -1), DiffuseMaterial((0.5,) * 3))
    light = quad((1.2, 1.9, 0), 0.2, (1, 0, 0), (0, 0, 1), EmissiveMaterial((30.0,) * 3))
    cam = make_camera(xform.translate((0.0, 2.0, 0.0)) @ xform.rotate_x(np.radians(-90.0)),
                      22.0, w, h)
    return Scene(shapes=[floor, occ, light], camera=cam)


def gradient_phases(dev, card, traversal, scene, sc, scene64, sc64, scene1k, sc1k):
    """Phases 19-23, the backward of the main path; returns the figures the
    result line needs."""
    import numpy as np
    import torch

    from akari_torch.diff.boundary import boundary_direct_term, build_edge_table
    from akari_torch.diff.inverse import InverseConfig, apply_params, inverse_render, scene_params
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.ops import dense_intersect as di
    from akari_torch.parallel.render import loss_and_image

    def grad_err(g, g_ref):
        return float((g - g_ref).abs().max() / g_ref.abs().max())

    def gib(nbytes):
        return nbytes / 2 ** 30

    def peak_of(fn):
        """(fn's result, peak bytes allocated during fn() above what was
        allocated before it, the absolute peak)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        return out, peak - base, peak

    # ---- phase 19: the bench step --------------------------------------------
    t_phase = time.perf_counter()
    res = sc.camera.width
    log(f"phase 19: the bench step: cornell {res}^2, spp 4, depth 5, NEE + MIS, loss and "
        f"d loss / d tex_value on the card [card: {card}]")
    cfg_b = PathConfig(spp=4, max_depth=5, mis=True, remat=False)
    target = torch.zeros((res, res, 3), device=dev)
    em = emissive_texels(scene)

    def launches_of_step(cfg_):
        """(loss, gradient, dense launches of the forward, of the backward)."""
        torch.cuda.synchronize()
        reset_all(traversal)
        p = scene_params(scene)
        p["tex_value"].requires_grad_(True)
        loss, _ = loss_and_image(apply_params(scene, p), sc.camera, cfg_, target)
        torch.cuda.synchronize()
        fwd = dict(di.LAUNCHES)
        (g,) = torch.autograd.grad(loss, [p["tex_value"]])
        torch.cuda.synchronize()
        bwd = {k: v - fwd[k] for k, v in di.LAUNCHES.items()}
        check(others(traversal, di) == 0, "other traversal kernels launched on the Cornell box")
        return loss.detach(), g, fwd, bwd

    (loss_k, g_k, fwd_l, bwd_l), peak_b, abs_b = peak_of(lambda: launches_of_step(cfg_b))
    log(f"  loss {float(loss_k):.8g}; dense launches: forward {fwd_l}, backward {bwd_l}")
    check(fwd_l == {"closest": 1 + cfg_b.max_depth, "any_hit": 0}
          and bwd_l == {"closest": 0, "any_hit": 0},
          f"bench step launches: forward {fwd_l}, backward {bwd_l}")
    check(bool(torch.isfinite(loss_k)) and bool(torch.isfinite(g_k).all()),
          "non-finite bench loss or gradient")
    check(bool((g_k[em] != 0).any()), "zero gradient on the emitter texel")
    loss_k2, g_k2 = bench_step(scene, sc.camera, cfg_b, target)
    with plain_route(di):
        loss_p, g_p = bench_step(scene, sc.camera, cfg_b, target)
    err_plain, err_rerun = grad_err(g_k, g_p), grad_err(g_k2, g_k)
    log(f"  gradient {np.array2string(g_k.cpu().numpy(), precision=6)}")
    log(f"  plain route: loss {'bit-equal' if torch.equal(loss_p, loss_k) else 'DIFFERS'}, "
        f"gradient max|diff| / max|g| {err_plain:.3e} (bound {GRAD_TOL}); kernel route "
        f"run to run {err_rerun:.3e}; loss run to run "
        f"{'bit-equal' if torch.equal(loss_k2, loss_k) else 'differs'}")
    check(torch.equal(loss_p, loss_k), "plain-route loss differs from the kernel route's")
    check(err_plain <= GRAD_TOL and err_rerun <= GRAD_TOL,
          f"gradient differs: plain {err_plain}, rerun {err_rerun}")
    step_q = event_quartiles(lambda: bench_step(scene, sc.camera, cfg_b, target))
    with torch.no_grad():
        fwd_q = event_quartiles(lambda: loss_and_image(scene, sc.camera, cfg_b, target))
    rays = cfg_b.spp * res * res * (2 * cfg_b.max_depth + 1)
    log(f"  fwd+bwd step: median {step_q[1]:.3f} ms, quartiles {step_q[0]:.3f} / "
        f"{step_q[2]:.3f} ms; forward alone: median {fwd_q[1]:.3f} ms, quartiles "
        f"{fwd_q[0]:.3f} / {fwd_q[2]:.3f} ms (CUDA events, 10 after 2 warm-ups) [card: {card}]")
    log(f"  rays_per_sec_per_chip_fwd_bwd_4spp_cornell: {rays / (step_q[1] / 1e3):.6g} "
        f"({rays} rays a step) [card: {card}]")

    p = scene_params(scene)
    p["tex_value"].requires_grad_(True)
    fwd_ev, (loss_, _) = device_events(
        lambda: loss_and_image(apply_params(scene, p), sc.camera, cfg_b, target))
    bwd_ev, _ = device_events(lambda: torch.autograd.grad(loss_, [p["tex_value"]]))
    bwd_busy = sum(e.device_time_total for e in bwd_ev) / 1e3
    index_add = sum(e.device_time_total for e in bwd_ev if "indexFunc" in e.name) / 1e3
    log(f"  CUDA launches: forward {len(fwd_ev)}, backward {len(bwd_ev)}; backward device "
        f"busy {bwd_busy:.3f} ms, index_add (row-gather backward) {index_add:.3f} ms "
        f"({index_add / max(bwd_busy, 1e-9):.3f} of it); peak memory of the step "
        f"{gib(peak_b):.3f} GiB above the {gib(abs_b - peak_b):.3f} GiB held before it "
        f"[card: {card}]")
    log(f"  phase 19: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 20: against the JAX package's gradient ------------------------
    log("phase 20: cornell 64^2 spp 4 depth 5 seed 0 loss and gradient vs the JAX package's")
    gold = np.load(GRAD_GOLDEN)
    loss64, g64 = bench_step(scene64, sc64.camera, PathConfig(spp=4, max_depth=5),
                             torch.zeros((64, 64, 3), device=dev))
    want = torch.from_numpy(gold["grad_tex_value"]).to(dev)
    rel_loss = abs(float(loss64) - float(gold["loss"])) / float(gold["loss"])
    rel_g = grad_err(g64, want)
    log(f"  loss {float(loss64):.8g} vs {float(gold['loss']):.8g}: relative {rel_loss:.3e} "
        f"(bound {GOLDEN_LOSS_RTOL}); gradient max|diff| / max|g_jax| {rel_g:.3e} "
        f"(bound {GOLDEN_GRAD_TOL})")
    check(rel_loss <= GOLDEN_LOSS_RTOL and rel_g <= GOLDEN_GRAD_TOL,
          f"64^2 gradient off the JAX package's: loss {rel_loss}, gradient {rel_g}")

    # ---- phase 21: remat -----------------------------------------------------
    t_phase = time.perf_counter()
    log(f"phase 21: PathConfig.remat at {res}^2 and at 1024^2 x 16 spp [card: {card}]")
    cfg_r = dataclasses.replace(cfg_b, remat=True)
    (loss_r, g_r, fwd_r, bwd_r), peak_r, _ = peak_of(lambda: launches_of_step(cfg_r))
    err_remat = grad_err(g_r, g_k)
    log(f"  remat: loss {'bit-equal' if torch.equal(loss_r, loss_k) else 'DIFFERS'}, gradient "
        f"max|diff| / max|g| {err_remat:.3e}; launches forward {fwd_r}, backward {bwd_r}; peak "
        f"of the step {gib(peak_r):.3f} GiB with remat, {gib(peak_b):.3f} GiB without")
    check(torch.equal(loss_r, loss_k) and err_remat <= GRAD_TOL,
          f"remat changed the step: loss equal {torch.equal(loss_r, loss_k)}, grad {err_remat}")
    check(fwd_r == fwd_l and bwd_r == {"closest": 0, "any_hit": 0},
          f"remat launches: forward {fwd_r}, backward {bwd_r}")
    res1k = sc1k.camera.width
    cfg1k = PathConfig(spp=16, max_depth=5, remat=True)
    target1k = torch.zeros((res1k, res1k, 3), device=dev)
    bench_step(scene1k, sc1k.camera, cfg1k, target1k)  # warm-up
    out = []
    ms1k, peak1k, abs1k = peak_of(lambda: cuda_ms(
        lambda: out.append(bench_step(scene1k, sc1k.camera, cfg1k, target1k)),
        iters=1, warmup=0))
    loss1k, g1k = out[0]
    rays1k = cfg1k.spp * res1k * res1k * (2 * cfg1k.max_depth + 1)
    log(f"  {res1k}^2 x {cfg1k.spp} spp depth 5 fwd+bwd under remat: {ms1k / 1e3:.4f} s "
        f"(CUDA events, one step after a warm-up), {rays1k / (ms1k / 1e3) / 1e6:.1f} M rays/s, "
        f"peak of the step {gib(peak1k):.3f} GiB ({gib(abs1k):.3f} GiB with what the run "
        f"held before it), loss {float(loss1k):.6g} [card: {card}]")
    # Finite but for the NaN the reference gives too (ROADMAP Queue 3): on
    # a few of these 16.8 M lanes a diffuse hit's masked microfacet
    # sampler takes sqrt'(0) times a zero cotangent, and the NaN reaches
    # only the alpha column, that is channel 0 of the roughness texels.
    alpha_texels = torch.zeros_like(g1k, dtype=torch.bool)
    alpha_texels[scene1k.materials.roughness_tex.long(), 0] = True
    nonfinite = ~torch.isfinite(g1k)
    log(f"  gradient: {int(nonfinite.sum())} non-finite entries (NaN "
        f"{int(torch.isnan(g1k).sum())}), at {torch.nonzero(nonfinite).tolist()}; allowed on "
        f"channel 0 of the roughness texels {torch.nonzero(alpha_texels).tolist()}")
    check(abs1k < CARD_BYTES, f"1024^2 remat peak {abs1k} bytes")
    check(bool(torch.isfinite(loss1k)) and not bool(torch.isinf(g1k).any())
          and not bool((nonfinite & ~alpha_texels).any()),
          "non-finite 1024^2 loss or gradient outside the parity NaN")
    del out, g1k
    torch.cuda.empty_cache()
    log(f"  phase 21: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 22: the boundary term ------------------------------------------
    t_phase = time.perf_counter()
    log("phase 22: tri_delta gradient of render + boundary_direct_term on the shadow scene "
        "(24x24), kernel route vs plain route")
    sc_sh = shadow_scene(24, 24)
    sh = sc_sh.compile(intersector="auto").to(dev)
    check(sh.intersector == "dense", f"shadow scene intersector {sh.intersector}")
    et = build_edge_table(sh)
    cam_sh = sc_sh.camera
    cfg_sh = PathConfig(spp=8, max_depth=1, ray_clamp=0.0)
    c = (sh.tri_v0 + (sh.tri_e1 + sh.tri_e2) / 3.0)[:, 1]
    occ_x = torch.zeros_like(sh.tri_v0)
    occ_x[(c - 1.0).abs() < 0.2, 0] = 1.0  # the occluder's two triangles, +x

    def boundary_grad():
        td = torch.zeros_like(sh.tri_v0, requires_grad=True)
        s = apply_params(sh, {"tex_value": sh.textures.value, "tri_delta": td})
        img = render(s, cam_sh, cfg_sh, seed=0)
        bnd = sum(boundary_direct_term(s, cam_sh, td, et, seed=0, edge_samples=4, sample_idx=si)
                  for si in range(4)) / 4.0
        loss = torch.mean(img + bnd.reshape(img.shape))
        (g,) = torch.autograd.grad(loss, [td])
        return g

    torch.cuda.synchronize()
    reset_all(traversal)
    g_bk = boundary_grad()
    torch.cuda.synchronize()
    bnd_launches = dict(di.LAUNCHES)
    with plain_route(di):
        g_bp = boundary_grad()
    err_bnd = grad_err(g_bk, g_bp)
    along = float((g_bk * occ_x).sum())
    log(f"  {et.a.shape[0]} edges; dense launches {bnd_launches}; d loss / d (occluder +x) "
        f"{along:.6g}; kernel vs plain route max|diff| / max|g| {err_bnd:.3e} "
        f"(bound {GRAD_TOL})")
    check(bnd_launches["any_hit"] > 0, "the boundary term launched no dense any-hit kernel")
    check(bool(torch.isfinite(g_bk).all()) and err_bnd <= GRAD_TOL and abs(along) > 0,
          f"boundary gradient: plain route {err_bnd}, along {along}")
    td0 = torch.zeros_like(sh.tri_v0, requires_grad=True)

    def one_boundary():
        out = boundary_direct_term(sh, cam_sh, td0, et, seed=0, edge_samples=4)
        torch.autograd.grad(out.sum(), [td0])

    bnd_q = event_quartiles(one_boundary)
    log(f"  one boundary_direct_term evaluation (24^2, 4 edge samples) fwd+bwd: median "
        f"{bnd_q[1]:.3f} ms, quartiles {bnd_q[0]:.3f} / {bnd_q[2]:.3f} ms [card: {card}]")
    log(f"  phase 22: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 23: the trainer -------------------------------------------------
    t_phase = time.perf_counter()
    log("phase 23: inverse_render, 20 iterations at 64^2 (spp 4, depth 2) from the walls' "
        "albedo at 0.4x")
    cfg_t = PathConfig(spp=4, max_depth=2)
    zeros64 = torch.zeros((64, 64, 3), device=dev)
    with torch.no_grad():
        _, target64 = loss_and_image(scene64, sc64.camera, cfg_t, zeros64, seed=123)
        v = scene64.textures.value
        bad = dataclasses.replace(scene64, textures=dataclasses.replace(
            scene64.textures, value=torch.where(emissive_texels(scene64)[:, None], v, 0.4 * v)))
        loss0 = float(loss_and_image(bad, sc64.camera, cfg_t, target64, seed=123)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, losses, _ = inverse_render(bad, sc64.camera, cfg_t, target64,
                                    InverseConfig(iterations=20, learning_rate=0.05))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        loss_end = float(loss_and_image(rec, sc64.camera, cfg_t, target64, seed=123)[0])
    log(f"  loss at the evaluation seed {loss0:.6g} -> {loss_end:.6g} ({loss_end / loss0:.3f} "
        f"of the start); iteration losses {losses[0]:.5g} ... {losses[-1]:.5g}; "
        f"{train_s / 20 * 1e3:.2f} ms an iteration (wall) [card: {card}]")
    check(loss_end < 0.5 * loss0, f"inverse_render did not halve the loss: {loss0} -> {loss_end}")
    log(f"  phase 23: {time.perf_counter() - t_phase:.1f} s")
    return {"boundary_any_hit_launches": bnd_launches["any_hit"]}


def slice4a_phases(dev, card, traversal, host1m, sc1m, cli_render):
    """Phases 24-28, the environment light, image textures and the AO and
    BDPT integrators; returns the figures the result line needs."""
    import numpy as np
    import torch

    from akari_torch.integrators import bdpt as pb
    from akari_torch.integrators.ao import AOConfig, render_ao
    from akari_torch.core.image import decode_png, write_png
    from akari_torch.integrators import path as path_mod
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.scene import sdl
    from akari_torch.scene.builtin import (
        cornell_box, envtex_sky, instanced_forest_scene, terrain_scene, write_envtex_terrain)
    from akari_torch.scene.nodes import EnvMapLight

    out = {}
    errs = []  # (closest, any-hit) max |kernel - plain| on each path's own rays

    def launches():
        return {f"{m.__name__.split('.')[-1]}.{n}": c for m in traversal
                for n, c in m.LAUNCHES.items() if c}

    # ---- phase 24: the env-lit textured OBJ through the CLI ----------------------
    t_phase = time.perf_counter()
    full = ENVTEX_FULL
    log(f"phase 24: env-lit textured terrain n={full['n']} as OBJ (vt) + MTL map_Kd "
        f"({full['tex_res']}^2 PNG) + EnvMap sky.hdr {full['sky_hw'][0]}x{full['sky_hw'][1]} + "
        f"its area light, {full['res']}^2 x {full['spp']} spp, depth {full['depth']}, NEE + MIS, "
        f"auto [card: {card}]")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        akari = write_envtex_terrain(tmp, **full)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "albedo.png"), "rb") as f:
            decode_png(f.read())
        png_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        node = sdl.parse_file(akari).exports["scene"]
        parse_s = time.perf_counter() - t0
        scene, compile_desc = compile_timed(node, dev, torch)
        check(scene.intersector == "tree" and scene.textures.has_images
              and tuple(scene.env_image.shape) == (*full["sky_hw"], 3)
              and scene.lights.n_lights == 2,
              f"envtex scene: {scene.intersector}, images {scene.textures.has_images}, "
              f"env {None if scene.env_image is None else tuple(scene.env_image.shape)}")
        log(f"  files written in {write_s:.2f} s; parse (OBJ + MTL + PNG) {parse_s:.2f} s, of "
            f"which the {full['tex_res']}^2 PNG decode {png_s:.2f} s; {scene.n_tris} tris, "
            f"images {tuple(scene.textures.images.shape)}, env_p_select "
            f"{float(scene.env_p_select):.4f}; {compile_desc}")
        cfg = node.integrator
        chunk = max(1, min(cfg.spp, path_mod.MAX_RAYS_IN_FLIGHT // full["res"] ** 2))
        n_trace = -(-cfg.spp // chunk)
        render(scene, node.camera, cfg, seed=0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all(traversal)
        img = []
        with kept_call(ti, ["closest"], keep=1) as calls:
            t0 = time.perf_counter()
            ms = cuda_ms(lambda: img.append(render(scene, node.camera, cfg, seed=0)), iters=1,
                         warmup=0)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = launches()
        log(f"  launches {got}; expected tree closest {n_trace} x (1 + {cfg.max_depth})")
        check(got == {"tree_intersect.closest": n_trace * (1 + cfg.max_depth)},
              f"envtex launches {got}")
        # the first bounce's fused launch (bounce rays + env and area shadow rays)
        rays_k, args_k = calls.kept["closest"]
        errs.append(compare_kernel("tree envtex fused launch", rays_k, ti, args_k,
                                   scene.n_tris)[:2])
        del calls, rays_k, args_k
        img_np = img[0].cpu().numpy()
        check_image(img_np, full["res"], "envtex")
        frame_line(f"envtex {full['res']}^2 spp {cfg.spp} depth {cfg.max_depth}", ms, wall,
                   peak, full["res"], cfg, card)
        out["envtex_ms"] = ms
        t0 = time.perf_counter()
        write_png(os.path.join(tmp, "frame.png"), img_np)
        log(f"  PNG write of the frame {time.perf_counter() - t0:.3f} s")
        out_png = os.path.join(tmp, "cli.png")
        reset_all(traversal)
        t0 = time.perf_counter()
        rc = cli_render.main(["-i", akari, "-o", out_png, "--device", "cuda", "-v"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        got = launches()
        check(rc == 0, f"CLI returned {rc}")
        check(got == {"tree_intersect.closest": n_trace * (1 + cfg.max_depth)},
              f"CLI envtex launches {got}")
        px = png_pixels(out_png)
        log(f"  CLI (parse OBJ + MTL + PNG + compile with env CDF + render + PNG): {cli_s:.3f} s "
            f"wall, PNG mean {px.mean():.1f}/255, launches {got} [card: {card}]")
        check(px.shape == (full["res"], full["res"], 3) and px.mean() > 20,
              f"CLI envtex image {px.shape}, mean {px.mean()}")
    del scene, img
    log(f"  phase 24: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 25: the env-lit textured golden ----------------------------------
    log("phase 25: env-lit textured terrain n=64 64x64 spp 4 depth 5 seed 0 vs the JAX "
        "package's golden")
    with tempfile.TemporaryDirectory() as tmp:
        node = sdl.parse_file(write_envtex_terrain(tmp, **ENVTEX_GOLDEN_SCENE)).exports["scene"]
        scene = node.compile().to(dev)
    check(scene.intersector == "tree", f"intersector {scene.intersector}")
    images_match(render(scene, node.camera, node.integrator, seed=0).cpu().numpy(),
                 np.load(ENVTEX_GOLDEN))

    # ---- phase 26: BDPT on the 2.09M-triangle terrain ----------------------------
    t_phase = time.perf_counter()
    cfg = pb.BDPTConfig(spp=BDPT_SPP)
    per_sample = cfg.eye_depth + cfg.light_depth - 1
    log(f"phase 26: render_bdpt(terrain_scene(256,256,n=1024), BDPTConfig(spp={cfg.spp})): "
        f"eye {cfg.eye_depth}, light {cfg.light_depth}, light tracing on [card: {card}]")
    t0 = time.perf_counter()
    scene1m = host1m[0].to(dev)
    torch.cuda.synchronize()
    log(f"  phase 9's host compile copied to the card in {time.perf_counter() - t0:.2f} s")
    cam = sc1m.camera
    pb.render_bdpt(scene1m, cam, pb.BDPTConfig(spp=1))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all(traversal)
    img = []
    with kept_call(ti, ["any_hit"]) as calls:
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: img.append(pb.render_bdpt(scene1m, cam, cfg)), iters=1, warmup=0)
        wall = time.perf_counter() - t0
    group_rays = calls.sizes["any_hit"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = launches()
    n_px = cam.width * cam.height
    entries = cfg.eye_depth * cfg.light_depth + cfg.light_depth
    log(f"  launches {got}: per sample {got.get('tree_intersect.closest', 0) / cfg.spp:g} "
        f"closest, {got.get('tree_intersect.any_hit', 0) / cfg.spp:g} any-hit; connection "
        f"group rays {sorted(set(group_rays))} (expected {entries} x {n_px} = {entries * n_px})")
    check(got == {"tree_intersect.closest": cfg.spp * per_sample,
                  "tree_intersect.any_hit": cfg.spp},
          f"BDPT launches {got}, expected {per_sample} closest and 1 any-hit a sample")
    check(set(group_rays) == {entries * n_px}, f"connection groups {group_rays}")
    img_np = img[0].cpu().numpy()
    check_image(img_np, cam.width, "BDPT terrain n=1024")
    rays = cfg.spp * n_px * (per_sample + entries)
    log(f"  BDPT {cam.width}^2 spp {cfg.spp}: {ms / 1e3:.4f} s/frame (CUDA events), {wall:.4f} s wall, "
        f"{cfg.spp * n_px / (ms / 1e3) / 1e6:.3f} M samples/s, {rays / (ms / 1e3) / 1e6:.1f} M "
        f"rays/s ({per_sample + entries} rays a sample and pixel), peak {peak:.2f} GiB "
        f"[card: {card}]")
    out["bdpt_ms"] = ms
    out["bdpt_any_hit"] = got["tree_intersect.any_hit"]
    # the first sample's connection group, through both kernels and their plain versions
    rays_k, args_k = calls.kept["any_hit"]
    errs.append(compare_kernel("tree BDPT connection group", rays_k, ti, args_k,
                               scene1m.n_tris)[:2])
    del calls, rays_k, args_k
    log(f"  phase 26: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 27: AO on the same terrain through the CLI ------------------------
    t_phase = time.perf_counter()
    log(f"phase 27: CLI --ao on the n=1024 terrain as OBJ + MTL + .akari, 256x256, AOConfig "
        f"defaults [card: {card}]")
    ao_cfg = AOConfig()
    render_ao(scene1m, cam, ao_cfg)  # warm-up
    torch.cuda.synchronize()
    reset_all(traversal)
    ms_ao = cuda_ms(lambda: render_ao(scene1m, cam, ao_cfg), iters=1, warmup=0)
    got = launches()
    check(got == {"tree_intersect.closest": ao_cfg.spp, "tree_intersect.any_hit": ao_cfg.spp},
          f"AO launches {got}")
    log(f"  render_ao {cam.width}^2 spp {ao_cfg.spp}: {ms_ao:.2f} ms (CUDA events), launches {got}")
    # one AO sample's camera and occlusion rays against the plain versions
    with kept_call(ti, ["closest", "any_hit"]) as calls:
        render_ao(scene1m, cam, AOConfig(spp=1))
    for what, kname in (("camera", "closest"), ("occlusion", "any_hit")):
        rays_k, args_k = calls.kept[kname]
        errs.append(compare_kernel(f"tree AO {what} rays", rays_k, ti, args_k,
                                   scene1m.n_tris)[:2])
    del calls, rays_k, args_k
    del scene1m
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        akari = write_terrain_obj(tmp, sc1m, cam.width, 4, 5)
        write_s = time.perf_counter() - t0
        out_png = os.path.join(tmp, "ao.png")
        reset_all(traversal)
        t0 = time.perf_counter()
        rc = cli_render.main(["-i", akari, "-o", out_png, "--device", "cuda", "--ao", "-v"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        got = launches()
        check(rc == 0, f"CLI --ao returned {rc}")
        check(got == {"tree_intersect.closest": ao_cfg.spp, "tree_intersect.any_hit": ao_cfg.spp},
              f"CLI --ao launches {got}")
        px = png_pixels(out_png)
    log(f"  OBJ written in {write_s:.1f} s; CLI --ao (parse OBJ + compile + render + PNG) "
        f"{cli_s:.2f} s wall, PNG mean {px.mean():.1f}/255, launches {got} [card: {card}]")
    check(px.shape == (cam.width, cam.width, 3) and px.mean() > 20,
          f"AO image {px.shape}, {px.mean()}")
    out["ao_any_hit"] = got["tree_intersect.any_hit"]
    log(f"  phase 27: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 28: goldens, routes, env on a two-level scene ---------------------
    t_phase = time.perf_counter()
    log("phase 28: BDPT (Cornell 64^2, spp 4) and AO (terrain n=64 64^2, spp 16) vs the JAX "
        "package's goldens; BDPT kernel route vs plain route; env-lit instanced-forest128")
    sc64 = cornell_box(64, 64)
    scene64 = sc64.compile().to(dev)
    cfg64 = pb.BDPTConfig(spp=4)
    px64 = torch.arange(64 * 64, device=dev)
    reset_all(traversal)
    acc, spl = pb.bdpt_sums(scene64, sc64.camera, cfg64, 0, px64)
    torch.cuda.synchronize()
    out["bdpt_dense_any_hit"] = di.LAUNCHES["any_hit"]
    check(di.LAUNCHES == {"closest": 4 * 6, "any_hit": 4}, f"BDPT 64 launches {di.LAUNCHES}")
    img64 = ((acc + spl) / cfg64.spp).reshape(64, 64, 3)
    images_match(img64.cpu().numpy(), np.load(BDPT_GOLDEN))
    with plain_route(di):
        acc_p, spl_p = pb.bdpt_sums(scene64, sc64.camera, cfg64, 0, px64)
    scale = float((acc + spl).abs().max())
    splat_err = float((spl - spl_p).abs().max()) / scale
    log(f"  kernel vs plain route: radiance bit-equal {torch.equal(acc, acc_p)}, splat "
        f"max |diff| / max|image| {splat_err:.3g} (bound {SPLAT_TOL})")
    check(torch.equal(acc, acc_p), "BDPT radiance differs between the kernel and plain routes")
    check(splat_err <= SPLAT_TOL, f"BDPT splat routes differ by {splat_err}")
    out["splat_err"] = splat_err
    sct = terrain_scene(64, 64, n=64)
    scene_t = sct.compile().to(dev)
    images_match(render_ao(scene_t, sct.camera, AOConfig()).cpu().numpy(), np.load(AO_GOLDEN))
    sc_f = instanced_forest_scene(256, 256)
    sc_f = dataclasses.replace(sc_f, environment=EnvMapLight(envtex_sky(256, 512), scale=0.5))
    forest, compile_f = compile_timed(sc_f, dev, torch)
    check(forest.instances is not None and forest.env_image is not None,
          "env-lit forest did not compile two-level with its environment")
    cfg_f = PathConfig(spp=4, max_depth=5)
    render(forest, sc_f.camera, cfg_f, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all(traversal)
    img = []
    t0 = time.perf_counter()
    ms_f = cuda_ms(lambda: img.append(render(forest, sc_f.camera, cfg_f, seed=0)), iters=1,
                   warmup=0)
    wall_f = time.perf_counter() - t0
    got = launches()
    check(got == {"instanced_tree_intersect.closest": 1 + cfg_f.max_depth},
          f"env-lit forest launches {got}")
    res_f = sc_f.camera.width
    check_image(img[0].cpu().numpy(), res_f, "env-lit instanced-forest128")
    frame_line(f"env-lit instanced-forest128 {res_f}^2 spp 4 depth 5", ms_f, wall_f,
               torch.cuda.max_memory_allocated() / 2 ** 30, res_f, cfg_f, card)
    log(f"  env-lit forest: {compile_f}; launches {got}")
    log(f"  phase 28: {time.perf_counter() - t_phase:.1f} s")
    out["tree_err"] = max(e for e, _ in errs)
    out["tree_occ_err"] = max(o for _, o in errs)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from akari_torch.bvh import cluster_tree as ct
    from akari_torch.cli import render as cli_render
    from akari_torch.core.v3 import V3
    from akari_torch.integrators import path as path_mod
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.kernels import build as kbuild
    from akari_torch.native import loader as native_loader
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import instanced_tree_intersect as iti
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.ops.intersect import occlude_soa
    from akari_torch.ops.ray_sort import sort_keys_soa
    from akari_torch.scene.builtin import (
        cornell_box,
        instanced_bench_scene,
        instanced_forest_scene,
        terrain_scene,
    )
    traversal = (di, ti, iti, ci)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- phase 1: setup -------------------------------------------------
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    log(f"phase 1: device {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
        native = pool.submit(native_loader.build)  # g++ beside the nvcc builds
        builds = {kname: pool.submit(kbuild.build, kname) for kname in KERNELS}
        libs = {kname: f.result() for kname, f in builds.items()}
        native_path = native.result()
    for kname in KERNELS:
        kbuild.load(kname)
    native_loader.load()
    build_s = time.perf_counter() - t0
    for kname, path in libs.items():
        log(f"  built {os.path.relpath(path, ROOT)}")
    log(f"  built {os.path.relpath(native_path, ROOT)} (g++, native BVH builder)")
    log(f"  all builds, in parallel: {build_s:.2f} s")
    for kname, (secs, report) in kbuild.BUILD_LOG.items():
        log(f"  nvcc {kname}: {secs:.2f} s; ptxas:\n    " + report.replace("\n", "\n    "))
    for kname in KERNELS:
        if kname in kbuild.BUILD_LOG:
            log(f"  {kname} registers / stack / spills:\n    "
                + ptxas_summary(kbuild.BUILD_LOG[kname][1]).replace("\n", "\n    "))

    # ---- phase 2: kernel vs plain on the card ---------------------------
    log("phase 2: kernel vs plain PyTorch version on the card")
    sc = cornell_box(256, 256)
    scene = sc.compile(intersector="auto").to(dev)
    check(scene.intersector == "dense", f"intersector {scene.intersector}")
    rays = make_rays(scene, sc.camera, N_RAYS, 0, torch)
    err_box, occ_box, _ = compare_kernel(
        "cornell", rays, di, (scene.prim_table,), scene.n_tris, max_ulp_allowed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    v0 = torch.rand((300, 3), generator=g, device=dev) * 2.0 - 1.0 + torch.tensor([0.0, 1.0, 0.0], device=dev)
    e1 = torch.randn((300, 3), generator=g, device=dev) * 0.3
    e2 = torch.randn((300, 3), generator=g, device=dev) * 0.3
    soup = torch.cat([v0, e1, e2], dim=1)
    soup[200:240] = soup[0:40]  # exact duplicates: ties go to the lower index
    soup = soup.contiguous()
    err_soup, occ_soup, _ = compare_kernel("soup", rays, di, (soup,), 300, max_ulp_allowed=0)
    adv_rays, adv_tris = adversarial_pack(dev, torch)
    err_adv, occ_adv, _ = compare_kernel("adversarial", adv_rays, di, (adv_tris,),
                                         adv_tris.shape[0], max_ulp_allowed=0)
    big_soup = torch.cat([torch.rand((4096, 3), generator=g, device=dev) * 1.8 - 0.9
                          + torch.tensor([0.0, 1.0, 0.0], device=dev),
                          torch.randn((4096, 6), generator=g, device=dev) * 0.2], dim=1)
    big_soup[3000:3100] = big_soup[30:130]  # duplicates across the chunks
    edge = []
    for n_ in RAY_COUNTS:  # the boundary of the make_rays pack's camera rays
        edge.append((f"{n_} rays x 36 tris",
                     rays[:, 262_000:262_000 + n_].contiguous(), scene.prim_table))
    sparse = rays[:, ::53].contiguous()
    for t_ in TRI_COUNTS:
        edge.append((f"{sparse.shape[1]} rays x {t_} tris", sparse, big_soup[:t_].contiguous()))
    for label, r_, t_ in edge:
        got, want = di.closest(r_, t_), di.closest_plain(r_, t_)
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"dense closest != plain: {label}")
        check(torch.equal(di.any_hit(r_, t_), di.any_hit_plain(r_, t_)),
              f"dense any-hit != plain: {label}")
    log(f"  dense kernels == plain bit for bit at ray counts {RAY_COUNTS} and triangle counts "
        f"{TRI_COUNTS}")
    max_abs_err = max(err_box, err_soup, err_adv)
    occ_abs_err = max(occ_box, occ_soup, occ_adv)

    # ---- phase 3: the main path at the bench width ----------------------
    log("phase 3: render(cornell_box(256,256), spp=4, max_depth=5) on cuda")
    cfg = PathConfig(spp=4, max_depth=5)
    n_px = sc.camera.width * sc.camera.height
    chunk = max(1, min(cfg.spp, path_mod.MAX_RAYS_IN_FLIGHT // n_px))
    n_trace = (cfg.spp + chunk - 1) // chunk
    torch.cuda.synchronize()
    reset_all(traversal)
    img = render(scene, sc.camera, cfg, seed=0)
    torch.cuda.synchronize()
    launches = dict(di.LAUNCHES)
    expected = n_trace * (1 + cfg.max_depth)
    log(f"  launches {launches}, others {others(traversal, di)}; expected closest = "
        f"{n_trace} trace_paths x (1 + {cfg.max_depth}) = {expected}")
    check(launches["closest"] == expected, f"launches {launches}, expected {expected}")
    check(others(traversal, di) == 0, "other traversal kernels launched on the Cornell box")
    img_np = img.cpu().numpy()
    check(img_np.shape == (256, 256, 3), f"image shape {img_np.shape}")
    check(bool(np.all(np.isfinite(img_np))), "non-finite radiance")
    mean = float(img_np.mean())
    mid = img_np[128]
    log(f"  image mean {mean:.5f} (> {MEAN_LIT_MIN}); left wall {mid[8]}, right wall {mid[-9]}")
    check(mean > MEAN_LIT_MIN, f"image too dark: mean {mean}")
    check(mid[8][0] > mid[8][1] and mid[-9][1] > mid[-9][0], "walls not red/green")

    # ---- phase 4: cross-framework golden --------------------------------
    log("phase 4: 64x64 spp 4 depth 5 seed 0 vs the JAX package's golden")
    sc64 = cornell_box(64, 64)
    scene64 = sc64.compile(intersector="auto").to(dev)
    img64 = render(scene64, sc64.camera, PathConfig(spp=4, max_depth=5), seed=0)
    golden = np.load(GOLDEN)
    images_match(img64.cpu().numpy(), golden)

    # ---- phase 5: realistic size ----------------------------------------
    log(f"phase 5: 1024x1024, 16 spp, depth 5 [card: {card}]")
    sc1k = cornell_box(1024, 1024)
    scene1k = sc1k.compile(intersector="auto").to(dev)
    cfg1k = PathConfig(spp=16, max_depth=5)
    render(scene1k, sc1k.camera, cfg1k, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame_ms = cuda_ms(lambda: render(scene1k, sc1k.camera, cfg1k, seed=0), iters=1, warmup=0)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    paths = 1024 * 1024 * 16
    rays_total = paths * (2 * cfg1k.max_depth + 1)
    log(f"  render: {frame_ms / 1e3:.4f} s/frame (CUDA events), {wall_s:.4f} s wall, "
        f"{paths / (frame_ms / 1e3) / 1e6:.2f} Mpaths/s, "
        f"{rays_total / (frame_ms / 1e3) / 1e6:.1f} M rays/s, peak {peak_gb:.2f} GiB "
        f"[card: {card}]")
    with tempfile.TemporaryDirectory() as tmp:
        out_png = os.path.join(tmp, "out.png")
        argv = ["-i", SCENE_FILE, "-o", out_png, "--width", "1024", "--height", "1024",
                "--spp", "16", "--max-depth", "5", "--device", "cuda"]
        check(cli_render.main(argv) == 0, "CLI warm-up failed")
        rcs = []
        t0 = time.perf_counter()
        cli_ms = cuda_ms(lambda: rcs.append(cli_render.main(argv)), iters=1, warmup=0)
        cli_s = time.perf_counter() - t0
        check(rcs == [0], f"CLI returned {rcs}")
        with open(out_png, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n", "CLI output is not a PNG")
        w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")
        check((w, h) == (1024, 1024), f"CLI image {w}x{h}")
    log(f"  CLI (parse + compile + render + PNG): {cli_ms / 1e3:.4f} s (CUDA events), "
        f"{cli_s:.4f} s wall [card: {card}]")

    # the dense kernels on the make_rays pack and on the rays of the main
    # path's first fused launch (cornell-256, 4 spp), closest and any-hit
    tris = scene.prim_table
    dense_sets = {
        "make_rays": rays[:, :FUSED_RAYS].contiguous(),
        "fused": capture_fused(di, "closest", lambda: render(scene, sc.camera, cfg, seed=0)),
    }
    err_fused, occ_fused, _ = compare_kernel("fused", dense_sets["fused"], di, (tris,),
                                             tris.shape[0], max_ulp_allowed=0)
    max_abs_err = max(max_abs_err, err_fused)
    occ_abs_err = max(occ_abs_err, occ_fused)
    dense_ms = {}
    for set_, r_ in dense_sets.items():
        for kname, fn, plain in (("dense_closest", di.closest, di.closest_plain),
                                 ("dense_any_hit", di.any_hit, di.any_hit_plain)):
            dense_ms[kname, set_] = (cuda_ms(lambda: fn(r_, tris), iters=50),
                                     cuda_ms(lambda: plain(r_, tris), iters=10))
        n_dead = int((~(r_[6] < torch.clamp(r_[7], max=di.T_MAX))).sum())
        log(f"  {set_} rays ({r_.shape[1]}, {n_dead} dead) x {tris.shape[0]} tris: closest "
            f"kernel {dense_ms['dense_closest', set_][0]:.4f} ms, plain "
            f"{dense_ms['dense_closest', set_][1]:.4f} ms; any-hit kernel "
            f"{dense_ms['dense_any_hit', set_][0]:.4f} ms, plain "
            f"{dense_ms['dense_any_hit', set_][1]:.4f} ms [card: {card}]")
    log(f"  phases 1-5: {time.perf_counter() - t_start:.1f} s")

    # ---- phase 6: tree kernel vs plain walk on the card -----------------
    t_phase = time.perf_counter()
    log("phase 6: tree kernel vs plain walk on the card")
    sc512 = terrain_scene(256, 256, n=512)
    scene512, compile512 = compile_timed(sc512, dev, torch)
    check(scene512.intersector == "tree", f"intersector {scene512.intersector}")
    check(scene512.n_tris == 522_244, f"n_tris {scene512.n_tris}")
    log(f"  terrain n=512: {scene512.n_tris} tris, {scene512.tri_tree.shape[0]} node rows, "
        f"leaf_span {scene512.tree_leaf_span}; {compile512}")
    targs = (scene512.tri_tree, scene512.tri_blocks, scene512.n_tris, scene512.tree_leaf_span)
    log(f"  triangle store: tri_blocks {store_mb(scene512.tri_blocks)} (tree and linear "
        "cluster kernels)")
    trays = make_rays(
        scene512, sc512.camera, TREE_RAYS, 2, torch,
        box=((-1.0, 0.0, -1.0), (1.0, 1.2, 1.0)),
        hit_t=lambda r: ti.closest_plain(r, *targs)[0],
    )
    err_terrain, occ_terrain, _ = compare_kernel(
        "tree terrain", trays, ti, targs, scene512.n_tris)
    soup_tris, sargs = tree_soup(dev, torch)
    srays = make_rays(
        SimpleNamespace(device=dev), sc512.camera, TREE_RAYS, 3, torch,
        box=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
        hit_t=lambda r: ti.closest_plain(r, *sargs)[0],
    )
    err_tsoup, occ_tsoup, (_, _, _, prim_soup) = compare_kernel(
        "tree soup", srays, ti, sargs, soup_tris.shape[0])
    sub = srays[:, :SOUP_SUBSET].contiguous()
    dense_prim = di.closest_plain(sub, soup_tris)[3]
    check(torch.equal(dense_prim >= 0, ti.any_hit(sub, *sargs)),
          "tree any-hit != dense plain validity on the soup")
    check(torch.equal(dense_prim, prim_soup[:SOUP_SUBSET]),
          "tree prim != dense plain prim on the soup (tie rule)")
    log(f"  tree soup: on {SOUP_SUBSET} rays tree any-hit == tree closest validity == "
        "dense plain validity, and prims equal (lowest index wins ties)")
    tree_err = max(err_terrain, err_tsoup)
    tree_occ_err = max(occ_terrain, occ_tsoup)
    log(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 7: the large-scene main path ------------------------------
    t_phase = time.perf_counter()
    log("phase 7: render(terrain_scene(256,256,n=512), spp=4, max_depth=5) on auto")
    cfg = PathConfig(spp=4, max_depth=5)
    render(scene512, sc512.camera, cfg, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all(traversal)
    out = []
    t0 = time.perf_counter()
    ms512 = cuda_ms(lambda: out.append(render(scene512, sc512.camera, cfg, seed=0)),
                    iters=1, warmup=0)
    wall512 = time.perf_counter() - t0
    tree_launches = dict(ti.LAUNCHES)
    dense_launches = dict(di.LAUNCHES)
    peak512 = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = n_trace * (1 + cfg.max_depth)
    log(f"  launches: tree {tree_launches}, dense {dense_launches}; expected tree "
        f"closest = {n_trace} trace_paths x (1 + {cfg.max_depth}) = {expected}")
    check(tree_launches == {"closest": expected, "any_hit": 0},
          f"tree launches {tree_launches}, expected {expected}")
    check(dense_launches == {"closest": 0, "any_hit": 0}, f"dense launches {dense_launches}")
    check(others(traversal, di, ti) == 0, "instanced or cluster kernels launched on terrain")
    check_image(out[0].cpu().numpy(), 256, "terrain n=512")
    frame_line("terrain n=512 256^2 spp 4 depth 5", ms512, wall512, peak512, 256, cfg, card)
    log(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 8: terrain golden -----------------------------------------
    log("phase 8: terrain n=64 64x64 spp 4 depth 5 seed 0 vs the JAX package's golden")
    sct = terrain_scene(64, 64, n=64)
    scene_t64 = sct.compile(intersector="auto").to(dev)
    check(scene_t64.intersector == "tree", f"intersector {scene_t64.intersector}")
    img_t64 = render(scene_t64, sct.camera, PathConfig(spp=4, max_depth=5), seed=0)
    images_match(img_t64.cpu().numpy(), np.load(TERRAIN_GOLDEN))

    # ---- phase 9: 2.09M triangles on auto --------------------------------
    t_phase = time.perf_counter()
    log("phase 9: render(terrain_scene(256,256,n=1024), spp=4, max_depth=5) on auto")
    sc1m = terrain_scene(256, 256, n=1024)
    host1m = []  # the host compile, copied to the card again in phase 26
    scene1m, compile1m = compile_timed(sc1m, dev, torch, host=host1m)
    check(scene1m.intersector == "tree" and scene1m.n_tris == 2_093_060,
          f"{scene1m.intersector}, {scene1m.n_tris} tris")
    log(f"  terrain n=1024: {scene1m.n_tris} tris, {scene1m.tri_tree.shape[0]} node rows, "
        f"leaf_span {scene1m.tree_leaf_span}; {compile1m}")
    img1m, ms1m, wall1m, peak1m = render_frame(render, scene1m, sc1m.camera, cfg, torch)
    check_image(img1m.cpu().numpy(), 256, "terrain n=1024")
    frame_line("terrain n=1024 256^2 spp 4 depth 5", ms1m, wall1m, peak1m, 256, cfg, card)
    del scene1m, img1m
    torch.cuda.empty_cache()
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 10: the CLI on a large OBJ --------------------------------
    t_phase = time.perf_counter()
    log("phase 10: CLI render of the n=512 terrain as OBJ + MTL + .akari, 256x256 spp 4")
    with tempfile.TemporaryDirectory() as tmp:
        akari = write_terrain_obj(tmp, sc512, 256, 4, 5)
        out_png = os.path.join(tmp, "terrain.png")
        reset_all(traversal)
        t0 = time.perf_counter()
        rc = cli_render.main(["-i", akari, "-o", out_png, "--device", "cuda", "-v"])
        cli_obj_s = time.perf_counter() - t0
        check(rc == 0, f"CLI returned {rc}")
        check(ti.LAUNCHES["closest"] > 0 and sum(di.LAUNCHES.values()) == 0,
              f"CLI launches: tree {ti.LAUNCHES}, dense {di.LAUNCHES}")
        px = png_pixels(out_png)
    check(px.shape == (256, 256, 3), f"CLI image {px.shape}")
    log(f"  CLI (parse OBJ + compile + render + PNG): {cli_obj_s:.3f} s wall, "
        f"PNG mean {px.mean():.1f}/255, tree launches {ti.LAUNCHES['closest']}")
    check(px.mean() > 20, f"CLI image too dark: {px.mean()}")
    log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 11: tree kernel and plain walk times ----------------------
    t_phase = time.perf_counter()
    log(f"phase 11: tree kernel vs plain walk at the fused shape [card: {card}]")
    rays_u = capture_fused(ti, "closest", lambda: render(scene512, sc512.camera, cfg, seed=0))
    k = (scene512.n_tris + 127) // 128
    key = sort_keys_soa(
        V3(*rays_u[0:3]), V3(*rays_u[3:6]),
        scene512.tri_clusters[:k, 0:3].min(0).values,
        scene512.tri_clusters[:k, 3:6].max(0).values, rays_u[6], rays_u[7],
        hint="secondary",
    )
    rays_s = rays_u[:, torch.argsort(key, stable=True)].contiguous()
    times = {}
    times["kernel_unsorted"] = cuda_ms(lambda: ti.closest(rays_u, *targs), iters=20)
    times["kernel_sorted"] = cuda_ms(lambda: ti.closest(rays_s, *targs), iters=20)
    times["any_hit_unsorted"] = cuda_ms(lambda: ti.any_hit(rays_u, *targs), iters=20)
    times["any_hit_sorted"] = cuda_ms(lambda: ti.any_hit(rays_s, *targs), iters=20)
    times["plain_sorted"] = cuda_ms(lambda: ti.closest_plain(rays_s, *targs), iters=1, warmup=1)
    n_dead = int((rays_u[7] <= rays_u[6]).sum())
    log(f"  fused launch: {FUSED_RAYS} rays ({n_dead} dead) x {scene512.n_tris} tris; "
        f"ms per call (CUDA events) [card: {card}]:")
    for name_, ms_ in times.items():
        log(f"    {name_}: {ms_:.4f} ms")
    tree_fig = {
        "closest": plain_figures(lambda r, stats=None: ti.closest_plain(r, *targs, stats=stats),
                                 rays_u, False, card),
        "any_hit": plain_figures(lambda r, stats=None: ti.any_hit_plain(r, *targs, stats=stats),
                                 rays_u, True, card),
    }
    for name_, key_ in (("closest", "kernel_unsorted"), ("any_hit", "any_hit_unsorted")):
        log(f"  tree {name_}: {times[key_]:.4f} ms, bound {tree_fig[name_][0]:.4f} ms "
            f"({tree_fig[name_][1]}) [card: {card}]")
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 12: instanced and linear kernels vs plain ----------------
    t_phase = time.perf_counter()
    log("phase 12: instanced tree, flat cluster and linear instanced kernels vs plain")
    sc_f = instanced_forest_scene(256, 256)
    forest, compile_f = compile_timed(sc_f, dev, torch)
    check(forest.instances is not None and forest.intersector == "tree",
          f"instanced-forest128 compiled {forest.intersector}, instances "
          f"{forest.instances is not None}")
    check(forest.n_tris == 4_129_026, f"virtual triangles {forest.n_tris}")
    log(f"  instanced-forest128: {forest.instances.n_instances} instances, {forest.n_tris} "
        f"world triangles, {forest.tri_v0.shape[0]} stored, {forest.tri_tree.shape[0]} node "
        f"rows, leaf_span {forest.tree_leaf_span}; {compile_f}")
    iargs = (forest.inst_f32, forest.inst_i32, forest.tri_tree, forest.inst_tri_blocks,
             forest.tree_leaf_span)
    log(f"  triangle store: inst_tri_blocks {store_mb(forest.inst_tri_blocks)} (instanced "
        "tree and linear instanced kernels)")
    frays = make_rays(
        forest, sc_f.camera, INST_RAYS, 4, torch, box=((-6.0, 0.0, -6.0), (6.0, 1.5, 6.0)),
        hit_t=lambda r: iti.closest_plain(r, *iargs)[0],
    )
    err_it, occ_it, hit_it = compare_kernel(
        "instanced tree", frays, iti, iargs, forest.n_tris, max_ulp_allowed=0)
    check_permuted("instanced tree", frays, iti, iargs, hit_it)
    st = soup_tris.cpu().numpy()
    scl = ct.build_clusters(st[:, 0:3], st[:, 3:6], st[:, 6:9])
    cargs = (torch.from_numpy(ct.build_superclusters(scl, st.shape[0])).to(dev),
             torch.from_numpy(scl).to(dev), sargs[1], st.shape[0])
    crays = make_rays(
        SimpleNamespace(device=dev), sc512.camera, INST_RAYS, 6, torch,
        box=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
        hit_t=lambda r: ci.closest_plain(r, *cargs)[0],
    )
    err_cl, occ_cl, hit_cl = compare_kernel(
        "flat cluster (soup, tree nulled)", crays, ci, cargs, st.shape[0], max_ulp_allowed=0)
    check(torch.equal(hit_cl[3], ti.closest(crays, *sargs)[3]),
          "flat cluster prims != tree walk prims on the soup (tie rule)")
    check_permuted("flat cluster", crays, ci, cargs, hit_cl)
    ncargs = (forest.inst_f32, forest.inst_i32, forest.tri_superclusters, forest.tri_clusters,
              forest.inst_tri_blocks)
    err_ic, occ_ic, hit_ic = compare_kernel(
        "linear instanced (forest, tree nulled)", frays, ci, ncargs, forest.n_tris,
        closest="instanced_closest", any_hit="instanced_any_hit", max_ulp_allowed=0)
    check(all(torch.equal(a, b) for a, b in zip(hit_ic, hit_it)),
          "linear instanced kernel != instanced tree kernel on the forest rays")
    log("  linear instanced kernel == instanced tree kernel on every forest ray")
    check_permuted("linear instanced", frays, ci, ncargs, hit_ic,
                   closest="instanced_closest", any_hit="instanced_any_hit")
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 13: instanced-forest128 on auto ----------------------------
    t_phase = time.perf_counter()
    log("phase 13: render(instanced-forest128 256x256, spp=4, max_depth=5) on auto")
    render(forest, sc_f.camera, cfg, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all(traversal)
    out = []
    t0 = time.perf_counter()
    ms_f = cuda_ms(lambda: out.append(render(forest, sc_f.camera, cfg, seed=0)),
                   iters=1, warmup=0)
    wall_f = time.perf_counter() - t0
    inst_launches = dict(iti.LAUNCHES)
    peak_f = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = n_trace * (1 + cfg.max_depth)
    log(f"  launches: instanced tree {inst_launches}, dense {di.LAUNCHES}, tree "
        f"{ti.LAUNCHES}, cluster {ci.LAUNCHES}; expected {expected}")
    check(inst_launches == {"closest": expected, "any_hit": 0},
          f"instanced tree launches {inst_launches}, expected {expected}")
    check(others(traversal, iti) == 0, "dense, tree or cluster kernels launched on the forest")
    check_image(out[0].cpu().numpy(), 256, "instanced-forest128")
    frame_line("instanced-forest128 256^2 spp 4 depth 5", ms_f, wall_f, peak_f, 256, cfg, card)
    log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 14: instanced-bench64 --------------------------------------
    t_phase = time.perf_counter()
    log("phase 14: render(instanced-bench64 256x256, spp=4, max_depth=5), forced two-level")
    sc_b = instanced_bench_scene(256, 256)
    with flatten_max_tris(1):
        bench64, compile_b = compile_timed(sc_b, dev, torch)
    check(bench64.instances is not None and bench64.n_tris == 64 * 32_258,
          f"instanced-bench64: {bench64.n_tris} virtual tris")
    log(f"  instanced-bench64: {bench64.n_tris} world triangles, "
        f"{bench64.tri_v0.shape[0]} stored; {compile_b}")
    reset_all(traversal)
    img_b, ms_b, wall_b, peak_b = render_frame(render, bench64, sc_b.camera, cfg, torch)
    log(f"  launches over warm-up + timed frame: instanced tree {iti.LAUNCHES}")
    check(iti.LAUNCHES["closest"] == 2 * expected and others(traversal, iti) == 0,
          f"instanced-bench64 launches {iti.LAUNCHES}")
    img_b = img_b.cpu().numpy()
    check(img_b.shape == (256, 256, 3) and not img_b.any(),
          "instanced-bench64 has no light: its image must be black")
    frame_line("instanced-bench64 256^2 spp 4 depth 5", ms_b, wall_b, peak_b, 256, cfg, card)
    del bench64
    torch.cuda.empty_cache()
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 15: instanced golden -----------------------------------------
    log("phase 15: instanced forest (8 x n=16) 64x64 spp 4 depth 5 seed 0 vs the golden")
    sc_g = instanced_forest_scene(64, 64, n_instances=8, n=16)
    with flatten_max_tris(1):
        scene_g = sc_g.compile().to(dev)
    check(scene_g.instances is not None, "the golden forest did not compile two-level")
    img_g = render(scene_g, sc_g.camera, PathConfig(spp=4, max_depth=5), seed=0)
    images_match(img_g.cpu().numpy(), np.load(INSTANCED_GOLDEN))

    # ---- phase 16: the CLI on 128 Instance nodes ----------------------------
    t_phase = time.perf_counter()
    log("phase 16: CLI render of 128 Instance nodes of a 32,258-triangle OBJ, 256x256 spp 4")
    with tempfile.TemporaryDirectory() as tmp:
        akari = write_forest_sdl(tmp, 256, 4, 5)
        out_png = os.path.join(tmp, "forest.png")
        reset_all(traversal)
        t0 = time.perf_counter()
        rc = cli_render.main(["-i", akari, "-o", out_png, "--device", "cuda", "-v"])
        cli_forest_s = time.perf_counter() - t0
        check(rc == 0, f"CLI returned {rc}")
        check(iti.LAUNCHES["closest"] > 0 and others(traversal, iti) == 0,
              f"CLI launches: instanced tree {iti.LAUNCHES}, others {others(traversal, iti)}")
        px = png_pixels(out_png)
    check(px.shape == (256, 256, 3), f"CLI image {px.shape}")
    log(f"  CLI (parse OBJ + SDL + two-level compile + render + PNG): {cli_forest_s:.3f} s "
        f"wall, PNG mean {px.mean():.1f}/255, instanced tree launches "
        f"{iti.LAUNCHES['closest']} [card: {card}]")
    check(px.mean() > 20, f"CLI image too dark: {px.mean()}")
    log(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 17: linear routes and occlusion queries ----------------------
    t_phase = time.perf_counter()
    log("phase 17: the linear kernels' routes (tree nulled) and occlude_soa on every route")
    forest_nt = dataclasses.replace(forest, tri_tree=None)
    terrain_nt = dataclasses.replace(scene512, tri_tree=None)
    linear = {}
    for label, scene_, cam_ in (("forest", forest_nt, sc_f.camera),
                                ("terrain", terrain_nt, sc512.camera)):
        render(scene_, cam_, cfg, seed=0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all(traversal)
        out = []
        t0 = time.perf_counter()
        ms_ = cuda_ms(lambda: out.append(render(scene_, cam_, cfg, seed=0)), iters=1, warmup=0)
        wall_ = time.perf_counter() - t0
        peak_ = torch.cuda.max_memory_allocated() / 2 ** 30
        linear[label] = dict(ci.LAUNCHES)
        log(f"  render({label}, tree nulled, 256^2 spp 4 depth 5): cluster {ci.LAUNCHES}, "
            f"others {others(traversal, ci)}")
        check(others(traversal, ci) == 0, f"{label}: other kernels on the linear route")
        check_image(out[0].cpu().numpy(), 256, f"{label} with its tree nulled")
        frame_line(f"{label}, tree nulled, 256^2 spp 4 depth 5", ms_, wall_, peak_, 256, cfg,
                   card)
    check(linear["forest"]["instanced_closest"] == n_trace * (1 + cfg.max_depth)
          and linear["terrain"]["closest"] == n_trace * (1 + cfg.max_depth),
          f"linear route launches {linear}")
    occ_launches = {}
    for label, scene_, rays_, mod in (
            ("cornell", scene, rays, di), ("terrain", scene512, trays, ti),
            ("forest", forest, frays, iti), ("terrain, tree nulled", terrain_nt, trays, ci),
            ("forest, tree nulled", forest_nt, frays, ci)):
        torch.cuda.synchronize()
        reset_all(traversal)
        occ = occlude_soa(scene_, V3(*rays_[0:3]), V3(*rays_[3:6]), rays_[6], rays_[7])
        torch.cuda.synchronize()
        occ_launches[label] = {k: v for m in traversal for k, v in
                               ((f"{m.__name__.split('.')[-1]}.{n}", c)
                                for n, c in m.LAUNCHES.items()) if v}
        log(f"  occlude_soa({label}): {int(occ.sum())} of {occ.shape[0]} occluded; "
            f"launches {occ_launches[label]}")
        check(sum(mod.LAUNCHES.values()) == 1 and others(traversal, mod) == 0,
              f"occlude_soa({label}) launches {occ_launches[label]}")
    any_hit_launches = {
        "dense": occ_launches["cornell"].get("dense_intersect.any_hit", 0),
        "tree": occ_launches["terrain"].get("tree_intersect.any_hit", 0),
        "instanced_tree": occ_launches["forest"].get("instanced_tree_intersect.any_hit", 0),
        "cluster": occ_launches["terrain, tree nulled"].get("cluster_intersect.any_hit", 0),
        "instanced_cluster": occ_launches["forest, tree nulled"].get(
            "cluster_intersect.instanced_any_hit", 0),
    }
    log(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 18: timings at the fused shape and lower bounds --------------
    t_phase = time.perf_counter()
    log(f"phase 18: instanced and linear kernels at the fused shape [card: {card}]")
    frays_u = capture_fused(iti, "closest", lambda: render(forest, sc_f.camera, cfg, seed=0))
    n_dead = int((frays_u[7] <= frays_u[6]).sum())
    log(f"  forest fused launch: {FUSED_RAYS} rays ({n_dead} dead); terrain fused launch "
        f"of phase 11 for the flat cluster kernel; ms per call (CUDA events):")
    cl_tabs = (scene512.tri_superclusters, scene512.tri_clusters, scene512.tri_blocks,
               scene512.n_tris)
    ms = {
        "instanced_tree_closest": cuda_ms(lambda: iti.closest(frays_u, *iargs), iters=20),
        "instanced_tree_any_hit": cuda_ms(lambda: iti.any_hit(frays_u, *iargs), iters=20),
        "instanced_cluster_closest": cuda_ms(
            lambda: ci.instanced_closest(frays_u, *ncargs), iters=10),
        "instanced_cluster_any_hit": cuda_ms(
            lambda: ci.instanced_any_hit(frays_u, *ncargs), iters=10),
        "cluster_closest": cuda_ms(lambda: ci.closest(rays_u, *cl_tabs), iters=10),
        "cluster_any_hit": cuda_ms(lambda: ci.any_hit(rays_u, *cl_tabs), iters=10),
    }
    for name_, ms_ in ms.items():
        log(f"    {name_}: {ms_:.4f} ms")
    fig = {
        "instanced_tree_closest": plain_figures(
            lambda r, stats=None: iti.closest_plain(r, *iargs, stats=stats), frays_u, False, card),
        "instanced_tree_any_hit": plain_figures(
            lambda r, stats=None: iti.any_hit_plain(r, *iargs, stats=stats), frays_u, True, card),
        "instanced_cluster_closest": plain_figures(
            lambda r, stats=None: ci.instanced_closest_plain(r, *ncargs, stats=stats),
            frays_u, False, card),
        "instanced_cluster_any_hit": plain_figures(
            lambda r, stats=None: ci.instanced_any_hit_plain(r, *ncargs, stats=stats),
            frays_u, True, card),
        "cluster_closest": plain_figures(
            lambda r, stats=None: ci.closest_plain(r, *cl_tabs, stats=stats), rays_u, False, card),
        "cluster_any_hit": plain_figures(
            lambda r, stats=None: ci.any_hit_plain(r, *cl_tabs, stats=stats), rays_u, True, card),
        "tree_closest": tree_fig["closest"],
        "tree_any_hit": tree_fig["any_hit"],
    }
    ms["tree_closest"] = times["kernel_unsorted"]
    ms["tree_any_hit"] = times["any_hit_unsorted"]
    for kname, any_hit_ in (("dense_closest", False), ("dense_any_hit", True)):
        for set_, r_ in dense_sets.items():  # the record holds the main path's rays
            b_ms, b_by = dense_bound(r_, tris, any_hit_)
            old_ms, old_by = dense_bound(r_, tris, any_hit_, live_only=False)
            k_ms, p_ms = dense_ms[kname, set_]
            log(f"    {kname} on the {set_} rays: {k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
                f"on the live rays, {k_ms / b_ms:.1f}x the bound; bound charging every ray "
                f"{old_ms:.4f} ms ({old_by}); plain {p_ms:.4f} ms [card: {card}]")
            fig[kname] = (b_ms, b_by, p_ms, r_.shape[1])
            ms[kname] = k_ms
    for kname in ("tree_closest", "tree_any_hit", "instanced_tree_closest",
                  "instanced_tree_any_hit", "cluster_closest", "cluster_any_hit",
                  "instanced_cluster_closest", "instanced_cluster_any_hit"):
        log(f"    {kname}: {ms[kname]:.4f} ms, bound {fig[kname][0]:.4f} ms ({fig[kname][1]}), "
            f"{ms[kname] / fig[kname][0]:.1f}x the bound [card: {card}]")
    log(f"  phase 18: {time.perf_counter() - t_phase:.1f} s")

    grad = gradient_phases(dev, card, traversal, scene, sc, scene64, sc64, scene1k, sc1k)
    s4a = slice4a_phases(dev, card, traversal, host1m, sc1m, cli_render)
    # the any-hit rows count every path's launches: the boundary term's side
    # probes and the BDPT connections (dense), occlude_soa, BDPT and AO (tree)
    any_hit_launches["dense"] = grad["boundary_any_hit_launches"] + s4a["bdpt_dense_any_hit"]
    any_hit_launches["tree"] += s4a["bdpt_any_hit"] + s4a["ao_any_hit"]
    # the tree rows' errors also cover the envtex, BDPT and AO paths' own rays
    tree_err = max(tree_err, s4a["tree_err"])
    tree_occ_err = max(tree_occ_err, s4a["tree_occ_err"])
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # ---- phase 29: result ----------------------------------------------------
    rows = [
        ("dense_closest", "dense_intersect.cu", "pallas_intersect.py:141",
         launches["closest"], max_abs_err),
        ("dense_any_hit", "dense_intersect.cu", "pallas_intersect.py:153",
         any_hit_launches["dense"], occ_abs_err),
        ("tree_closest", "tree_intersect.cu", "pallas_tree.py:194",
         tree_launches["closest"], tree_err),
        ("tree_any_hit", "tree_intersect.cu", "pallas_tree.py:194",
         any_hit_launches["tree"], tree_occ_err),
        ("instanced_tree_closest", "instanced_tree_intersect.cu", "pallas_tree.py:459",
         inst_launches["closest"], err_it),
        ("instanced_tree_any_hit", "instanced_tree_intersect.cu", "pallas_tree.py:459",
         any_hit_launches["instanced_tree"], occ_it),
        ("cluster_closest", "cluster_intersect.cu", "pallas_cluster.py:112",
         linear["terrain"]["closest"], err_cl),
        ("cluster_any_hit", "cluster_intersect.cu", "pallas_cluster.py:112",
         any_hit_launches["cluster"], occ_cl),
        ("instanced_cluster_closest", "cluster_intersect.cu", "pallas_cluster.py:253",
         linear["forest"]["instanced_closest"], err_ic),
        ("instanced_cluster_any_hit", "cluster_intersect.cu", "pallas_cluster.py:253",
         any_hit_launches["instanced_cluster"], occ_ic),
    ]
    kernels = []
    for kname, src, repl, n_launch, err in rows:
        b_ms, b_by, p_ms, p_rays = fig[kname]
        check(n_launch > 0, f"{kname} was launched no time on its path")
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"akari_torch/kernels/csrc/{src}",
            "replaces": f"akari_tpu/ops/{repl}",
            "launches": n_launch,
            "max_abs_err": err,
            "ms": ms[kname],
            "plain_ms": p_ms,
            "plain_rays": p_rays,
            "bound_ms": b_ms,
            "bound_by": b_by,
            # no single PyTorch call computes a closest or any ray-triangle hit
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0



if __name__ == "__main__":
    sys.exit(main())
