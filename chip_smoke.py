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
29. the bfloat16 variant: phase 5's Cornell box at 1024^2 x 16 spp, depth 5,
    in ``RGB_BF16`` and in ``RGB`` in one call: frame time (CUDA events),
    CUDA launches (profiler), dense launches, peak memory and the mean
    relative image delta against float32; the CLI with ``--spectrum-dtype
    bfloat16`` (the variant logged, its image equal to ``render``'s); the
    64x64 bfloat16 golden (tests/data/torch_port_cornell64_spp4_d5_bf16.npy);
30. progressive: ``render_progressive`` on phase 9's host compile of the
    2,093,060-triangle terrain, 256^2 x 64 spp, ``spp_chunk=4``,
    ``checkpoint_every=4``: an uninterrupted run (6 tree closest launches a
    chunk, wall time per chunk, checkpoint write time); a run preempted
    just after its checkpoint at 32 spp and resumed from it (bit-equal to
    the uninterrupted image, launches of the 8 chunks left); one pass of 64
    spp (rtol 1e-5, atol 1e-6);
31. the mesh cache: ``akari_torch.cli.importer`` on phase 27's terrain OBJ
    (written again), then the CLI at 256^2 x 4 spp on a scene importing
    the generated ``.akari`` and on the OBJ scene: parse time and time to
    first image of both routes, 6 tree launches each, bit-equal images;
32. texel recovery: the textured Cornell box at 128^2 x 4 spp, depth 3, its
    texels and values at 0.4x: 50 ``inverse_render`` iterations with
    ``optimize_images=True`` in log space (the loss at seed 0 falls below
    ``RECOVERY_LOSS_RATIO`` of its start); the step's quartiles, forward
    and backward CUDA launches (dense launches in the forward only) and
    the ``index_add`` share of the backward's device time; the 64x64
    ``tex_images`` gradient against the JAX package's
    (tests/data/torch_port_texgrad_cornell64.npz, ``GOLDEN_GRAD_TOL``) and
    the plain route's (``GRAD_TOL``);
33. the CLI with ``--profile -v``: the span table (render/path,
    write_image) within the CLI's wall time, elapsed-stamped log lines;
34. the bench step sharded (``loss_and_image_sharded``, the JAX package's
    ``bench.py:43-91`` step over its ray mesh): ranks are spawned
    processes (``akari_torch.parallel.launch.spawn_ranks``), R = 1 over
    NCCL and R = 2 sharing the one card over gloo (NCCL refuses two ranks
    on one GPU, so NCCL across cards is not exercised): loss (rtol 1e-5)
    and gradient (1e-5 of max|g|) against the unsharded step on the card,
    every rank's loss, image and gradient bit-equal, dense launches per
    rank, each rank's first fused dense launch against the plain version
    (prims exact, t/u/v within 2 ulp), step median of 10 after 2 warm-ups,
    all-reduce times at the step's shapes;
35. BASELINE.json config 5 sharded: ``render_sharded`` with
    ``BDPTConfig(spp=64)`` on the 2,093,060-triangle terrain at 256^2, R = 2
    (each rank compiles the terrain on the host and moves it to the card):
    against phase 26's unsharded image (rtol 1e-5, atol 1e-5; the splat
    within ``SPLAT_TOL``), tree launches per rank, each rank's first
    connection group (491,520 rays) against the plain walk, wall time;
36. ``render_progressive(mesh=...)`` on the same ranks: 16 spp in 4 chunks,
    preempted on every rank at 8 spp after the checkpoint there and
    resumed (tests/_sharded_ranks.py's harness; bit-equal to the
    uninterrupted sharded run; rank 0 alone writes), each chunk timed with
    its tree launches;
37. the JAX package's multi-device dry run (``__graft_entry__.py``: a
    two-level instanced floor under an env map, bf16, 64^2 x 4 spp, depth
    5) on phase 34's R = 2 ranks: loss (rtol 1e-6) and gradient (1e-5 of
    max|g|) against R = 1, instanced tree launches per rank, each rank's
    first fused instanced tree launch against the plain walk;
38. the CLI ``--sharded`` under ``torch.distributed.run
    --nproc-per-node=1`` (NCCL) on scenes/cornell_box/scene.akari: its PNG
    equal to the unsharded CLI's;
39. ``tools/distributed_check_torch.py`` at R = 1 and 2 (both run beside
    phase 38's CLI: they check results only), then ``bench_scaling_torch``
    alone (R = 1, 2 on one card); their JSON lines logged;
40. the port's benchmark in this process: ``bench_torch.primary`` (the
    bench step through ``loss_and_image_sharded`` over a 1-rank ray mesh,
    2 warm-ups and 10 timed steps): its lines, the last one's four keys and
    metric name, 6 dense closest launches a step, its loss bit-equal to
    phase 19's unsharded step; then the per-stage table's AoS ``intersect``
    / ``occlude`` (``ops/intersect.py``) on 65,536 camera rays of the
    Cornell box (dense), terrain512 (tree) and instanced-bench64 (forced
    two-level, instanced tree; its camera sees none of its instances, so
    as many rays again go down onto them), one closest and one any-hit
    launch each, against the same calls through the plain versions (prims
    and occlusion exact, t/u/v within 2 ulp);
41. image decoding without PIL (the card's machine has none): every
    fixture of ``tests/data/torch_port_images`` (baseline, progressive,
    restart, RGB-kept, grey and 16-bit-table JPEGs, palette, LA, Adam7 and
    16-bit PNGs) decoded by the port, its SHA-256 held to PIL's in
    ``digests.json``; the 2048^2 config-3 albedo as a 4:2:0 JPEG and phase
    24's 2048^2 PNG decoded, median of 3 each; then phase 24's CLI with
    ``map_Kd`` on that JPEG, on a PNG of its decoded pixels (lossless, so
    the frame must be bit-equal) and on the JPEG again, each with its tree
    launches, parse time and time to first image;
42. the TGA, BMP, PNM, GIF and PSD decoders: their fixtures' digests, the
    2048^2 albedo in each format (decode times beside phase 41's PNG
    median), and the config-3 CLI on the TGA-RLE and BMP albedos (frames
    bit-equal, 6 tree closest launches each, held to phase 51's PNG-route
    frame of the same pixels: phase 54 took its own PNG route run and
    PNG / JPEG medians, and those of phases 43, 44 and 46);
43. the TIFF decoder and the CMYK / YCCK JPEGs: the TIFF and CMYK
    fixtures' digests; the 2048^2 albedo as TIFF raw, PackBits, LZW, LZW
    with the horizontal predictor, tiled LZW, Deflate in planes and 16-bit
    Deflate with the predictor (written by the fixture tool's
    ``tiff_bytes``, LZW strips compressed in parallel processes), each
    decode's median of 3 no slower than the PNG route's; the config-3 CLI
    on the 8-bit LZW-with-predictor and the 16-bit Deflate TIFF albedos
    (frames bit-equal, 6 tree closest launches each, held to phase 51's
    PNG-route frame of the same pixels: phase 54 took its own PNG route
    run); and ``--sharded --ao``
    on the Cornell box at 64^2, exit 0 and the unsharded CLI's PNG;
44. the WebP decoder: the WebP fixtures' digests (lossy, lossless,
    palettes, alpha, animations, a random VP8 frame); the 2048^2 albedo as
    the committed lossy WebP and as a lossless one written here by
    ``vp8l_bytes`` (the machine has no encoder), each decode's median of 3
    no slower than the PNG route's; the config-3 CLI on the lossy WebP and
    on the lossless WebP (6 tree closest launches each, the lossless one's
    frame bit-equal to phase 51's PNG route of the same pixels; the lossy
    one's PNG route of its pixels is held on the CPU by
    ``tests/test_torch_image_webp.py``, as phase 54 took its run);
45. the DDS, BLP and FTEX decoders: their fixtures' digests (every BCn
    form, the DX10 header, the mask, luminance and palette forms, BLP1
    JPEG and palette, BLP2 palette and DXT, FTEX); the 2048^2 albedo
    written here by ``tools/dds_writers.py`` as BC1 (FourCC DXT1) and as
    BC7 (DX10, BC7_UNORM_SRGB), each with its full mip chain, each
    decode's median of 3 no slower than the PNG route's; the config-3 CLI
    on each DDS (6 tree closest launches each; the PNG route of a DDS's
    pixels is held on the CPU by ``tests/test_torch_image_dds.py``);
46. the ICO / CUR, QOI, SGI and PCX decoders and the LZMA / ZSTD TIFF
    strips: their fixtures' digests; the 2048^2 albedo written here as
    QOI, RLE SGI and 24-bit RLE PCX by ``tools/legacy_writers.py`` and as
    an LZMA TIFF with the horizontal predictor by ``tiff_bytes``, and the
    committed 2048^2 ZSTD TIFF, each decode's median of 3 no slower than
    the PNG route's (LZMA, decoded by Python's ``lzma``, recorded); the
    config-3 CLI on the RLE SGI and PCX albedos (frames bit-equal, and to
    phase 51's PNG route of the same pixels, 6 tree closest launches each);
47. the arithmetic-coded, lossless and cut progressive JPEGs: their
    fixtures' digests; the 2048^2 albedo as an arithmetic-coded
    progressive JPEG (the committed baseline JPEG re-coded here by
    ``tools/jpeg_writers.py``, decoding to the baseline's pixels), as a
    lossless JPEG written here (decoding to the albedo) and as the
    committed progressive JPEG cut after its 6th scan (block smoothing),
    each decode's median of 3 beside the PNG and baseline JPEG routes';
    the config-3 CLI on a PNG of the arithmetic file's pixels and on the
    arithmetic file (frames bit-equal, 6 tree closest launches each);
48. the CCITT, ThunderScan and old-style JPEG TIFF decoders: their
    fixtures' digests; the 2048^2 albedo as a Group 4 TIFF of its luma
    below the median and a ThunderScan TIFF of its luma's top four bits
    (written here by ``tools/tiff_writers.py`` over spawned processes,
    decoding to what was written) and the committed JPEG wrapped as an
    old-style JPEG TIFF, each decode's median of 3 beside the PNG route's;
    the config-3 CLI on the Group 4 file and on the old-style JPEG (6 tree
    closest launches each; the PNG route of a TIFF's pixels is held on the
    CPU by ``tests/test_torch_image_tiff.py``; no launch held to the plain
    walk since phase 53 came: phase 51 and the path phases hold the tree
    kernel to it);
49. the JPEG 2000 decoder: the J2K / JP2 fixtures' digests (both
    wavelets, the five progressions, tiles, tile-parts, precincts, POC,
    every code-block style, ROI, subsampled, signed and 1-16-bit
    components, PPM / PPT, the JP2 colour spaces and palettes); the
    committed 2048^2 albedo as an irreversible (9/7) JP2 at a rate of 30
    and as a reversible (5/3) codestream of the 64^2 albedo scaled up 32x
    (decoding to those pixels exactly), each decode's median of 3 beside
    the PNG route's; the config-3 CLI on a PNG of the JP2's pixels, on the
    JP2, on a PNG of the scaled-up albedo and on the J2K (frames bit-equal
    pairwise, 6 tree closest launches each; the J2K's frame is phase 53's
    reference);
50. Lab, PIL's other PNM modes, DIB and ICNS: their fixtures' digests;
    the 2048^2 albedo written here with integer numpy
    (``lab_albedo_files`` of ``tools/make_torch_port_image_fixtures.py``)
    as a raw and an LZW Lab TIFF, a PackBits Lab PSD, a ``Pf`` PFM and a
    24-bit DIB, each file's SHA-256 and decode held to the record of PIL's
    read (``tests/data/torch_port_generated_images.json``), each decode's
    median of 3 beside the PNG route's (DIB and PFM no slower); the
    config-3 CLI on a PNG of the LZW Lab TIFF's pixels and on that TIFF
    (frames bit-equal, 6 tree closest launches each);
51. the formats PIL tries on every file (IM, IMT, IPTC, PCD, SPIDER) with
    DCX, MSP and XBM: their fixtures' digests; the 2048^2 albedo written
    here with integer numpy (``plugin_albedo_files``) as an IM ``RGB
    image`` (planar rows), a DCX of a 24-bit RLE PCX page and a rotated
    PhotoCD base image of its channels, each file's SHA-256 and decode held
    to the record of PIL's read, each decode's median of 3 beside the PNG
    route's (the IM no slower); the config-3 CLI on a PNG of the IM file's
    pixels and on the IM file (frames bit-equal, 6 tree closest launches
    each, one launch of the IM run held to the plain walk at 0 ulp).
    To make room, phases 42-47, 49 and 50 hold no launch of their CLI runs
    to the plain walk (their held launches saw the same rays, dead rays
    and hits as phase 51's; phase 48's Group 4 albedo gave other rays and
    kept its held launch until phase 53 came), and phases 41-53 share one
    encode and decode of phase 24's albedo.png (``albedo_png``) and one
    timing of the PNG decode, phase 41's median of 3 (``png_decode_median``);
52. PIL's last plugins that load pixels (Sun raster, FLI / FLC, FITS,
    GBR, McIdas, PIXAR, XPM, XV thumbnail): their fixtures' digests; the
    2048^2 albedo written here with integer numpy
    (``raster_albedo_files``) as a 24-bit run-length Sun raster, an FLC
    whose frame 0 is a BRUN chunk of its RGB332 indices and a raw 8-bit
    FITS, each file's SHA-256 and decode held to the record of PIL's read,
    each decode's median of 3 beside phase 41's PNG median (the Sun raster
    no slower); one config-3 CLI run on the Sun raster (6 tree closest
    launches), its frame bit-equal to phase 51's PNG-route frame of the
    same pixels (no launch held: phase 51's held launch saw the same rays);
53. HTJ2K (JPEG 2000 Part 15) and the Part-2 MCT / MCC / MCO / CBD
    markers: the ``htj2k_*`` and ``part2_*`` fixtures' digests; the 64^2
    albedo scaled up 32x as a reversible 5/3 + RCT HT codestream (written
    by the HT writer of ``tools/j2k_writers.py`` in a process of its own
    from phase 1 on, ``start_htj2k_albedo``: 1.18 MB, past the committed
    fixtures' budget), decoding to those pixels exactly, its decode's
    median of 3 beside phase 41's PNG median and phase 49's J2K median;
    one config-3 CLI run on it (6 tree closest launches), its frame
    bit-equal to phase 49's on the J2K of the same pixels (no launch held);
54. AVIF: the fixtures of ``tests/data/torch_port_avif`` (format, PIL's
    mode and digest; 4:2:0 / 4:2:2 / 4:4:4 / grey, alpha, tiles, palettes,
    lossless, idat, nclx matrices, the tools of PIL's writer's speeds 0-4 and
    ``advanced`` options: CDEF, quantizer matrices, film grain, loop
    restoration, delta q / lf, intra block copy, segmentation; sequences
    and a grid; 10- and 12-bit, superres and hidden-frame rewrites); three
    committed 2048^2 albedos, each decode's median of 3 beside phase 41's
    PNG median: quality 60, speed 6 (287,591 bytes: 128x128 superblocks,
    4 x 2 tiles), speed 4 with CDEF, quantizer matrices, film grain and
    loop restoration, and frame 0 of a two-frame ``aq-mode=1`` ``avis``
    sequence (153,394 bytes, segmented); header rewrites of them made here
    (``tools/av1_rewrite.py``): the speed-4 albedo at 10 and 12 bits and
    the speed-6 one at superres 12/8 (3,072 wide), and the committed
    two-frame albedo sequence spliced into inter frame 0 (slice 26), each
    file and decode held to PIL's recorded read, each decode's median of 3;
    the config-3 CLI on a PNG of the inter-frame albedo's pixels and on
    that AVIF (frames bit-equal, 6 tree closest launches each);
55. the result: a JSON line of kernel records (the dense records on the
    captured fused rays; the any-hit records count phase 17's queries,
    phase 22's side probes and the BDPT and AO launches of phases 26-28;
    the tree records' errors cover phases 6, 24, 26, 27, 35, 40 and 51,
    the dense and instanced tree records' those of phases 34, 37 and 40),
    then the device line.

Each phase of the new paths (3, 7, 10, 13, 16, 17, 24, 26-37, 40-54) sets the
kernels' launch counts to 0 just before its run and reads them just after
(in each rank's process for 34-37).

Every kernel source (and the native BVH builder, JPEG Huffman and
arithmetic decoders, GIF and TIFF LZW decoders, WebP decoders, BCn decoder, QOI decoder, SGI /
PCX / Sun / FLI / ThunderScan run-length decoder, ZSTD decoder, CCITT decoder, JPEG 2000
decoder, Lab evaluator and AV1 decoder) is
built at start, one
compiler process each, all started together. Imports nothing of JAX.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
# Phase 41: the decoders' fixtures (tools/make_torch_port_image_fixtures.py)
IMAGE_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_images")
ALBEDO_JPEG = "albedo2048_q85_420.jpg"   # envtex_texture(2048, 0), 4:2:0, quality 85
ALBEDO_WEBP = "albedo2048_q85.webp"      # envtex_texture(2048, 0), lossy WebP, quality 85
TRI_COUNTS = (1, 35, 36, 37, 255, 256, 257, 4096)    # across the chunk and DENSE_MAX_TRIS
BF16_SPP = 16                    # phase 29's frames: Cornell 1024^2 (phase 5's scene)
BF16_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_cornell64_spp4_d5_bf16.npy")
BF16_DELTA_MAX = 0.02            # mean |bf16 - f32| / mean |f32| of the 1024^2 frames
PROG_SPP, PROG_STOP = 64, 32     # phase 30: samples, and where the interrupted run stops
RECOVERY_RES, RECOVERY_ITERS = 128, 50
RECOVERY_LOSS_RATIO = 0.3        # phase 32: the loss falls below this share of its start (CPU: 0.210)
TEXGRAD_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_texgrad_cornell64.npz")
# Phases 34-39, the ray-sharded paths at full width: the bench step's
# Cornell box, the dry run's scene, BASELINE.json config 5 (BDPT 64 spp on
# the 2,093,060-triangle terrain at 256^2) and a progressive render on it;
# the CLI at the scene file's own settings; the scaling bench at its 256^2.
SHARDED = dict(step_res=256, dryrun_res=64, terrain_n=1024, terrain_res=256, bdpt_spp=BDPT_SPP,
               prog_spp=16, prog_chunk=4, prog_stop=8, cli_args=[])
SHARD_TIMEOUT_S = 300.0          # each spawn of ranks, and each tool, joins within this


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
    _sync(rays.device)
    t1 = time.perf_counter()
    t_p, u_p, v_p, p_p = getattr(mod, closest + "_plain")(rays, *args)
    occ_p = getattr(mod, any_hit + "_plain")(rays, *args)
    _sync(rays.device)
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
    scene = scene_node.compile(intersector="auto", device="cpu")  # the host copy, kept
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
    ``warmup`` on the bench's clock (``bench_torch.step_times``: each call
    between two CUDA events on an idle card, host dispatch included: these
    steps are host-bound)."""
    import torch

    import bench_torch

    s = bench_torch.timed(fn, torch.device("cuda"), iters, warmup)
    return s["q1_ms"], s["median_ms"], s["q3_ms"]


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
        f"{fwd_q[0]:.3f} / {fwd_q[2]:.3f} ms (bench_torch.step_times: CUDA events, 10 after 2 "
        f"warm-ups) [card: {card}]")
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
    sh = sc_sh.compile(intersector="auto", device=dev)
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
    return {"boundary_any_hit_launches": bnd_launches["any_hit"], "bench_loss": loss_k}


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
        scene = node.compile(device=dev)
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
    out["bdpt_image"] = img_np  # phase 35's sharded frame is held against it
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
    scene64 = sc64.compile(device=dev)
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
    scene_t = sct.compile(device=dev)
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


@contextlib.contextmanager
def captured_write_png():
    """Keep the float image each ``write_png`` call writes (the CLI writes
    its render through it): ``images`` lists them in call order."""
    from akari_torch.core import image

    real = image.write_png
    images = []

    def keep(path, img):
        images.append(img)
        return real(path, img)

    image.write_png = keep
    try:
        yield images
    finally:
        image.write_png = real


@contextlib.contextmanager
def log_records():
    """The port logger's messages during the block, each with its
    elapsed-time stamp as the CLI prints it."""
    import io
    import logging

    from akari_torch.utils.logger import _ElapsedFormatter, add_handler, get_logger

    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    h.setFormatter(_ElapsedFormatter())
    add_handler(h)
    try:
        yield buf
    finally:
        get_logger().removeHandler(h)


def parsed_seconds(text):
    """The CLI's ``parsed in X s`` figure from its log text."""
    import re

    m = re.findall(r"parsed in ([0-9.]+)s", text)
    check(len(m) == 1, f"no single 'parsed in' line in the CLI log: {m}")
    return float(m[0])


def slice4b_phases(dev, card, traversal, scene1k, sc1k, host1m, sc1m, cli_render):
    """Phases 29-33: the bfloat16 variant, progressive checkpointed renders,
    the mesh cache and importer, texel recovery and the CLI's --profile;
    returns the launch counts of the new paths."""
    import io

    import numpy as np
    import torch

    from akari_torch.cli import importer
    from akari_torch.diff.inverse import InverseConfig, apply_params, inverse_render, scene_params
    from akari_torch.integrators import path as path_mod
    from akari_torch.integrators import progressive
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.integrators.progressive import render_progressive
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.parallel.render import loss_and_image
    from akari_torch.scene import meshcache
    from akari_torch.scene.builtin import cornell_box, textured_cornell_box
    from akari_torch.utils import profiler
    from akari_torch.utils.checkpoint import load_render_state
    from akari_torch.utils.config import RGB, RGB_BF16, variant_string

    out = {}

    def launches():
        return {f"{m.__name__.split('.')[-1]}.{n}": c for m in traversal
                for n, c in m.LAUNCHES.items() if c}

    # ---- phase 29: the bfloat16 spectrum variant ----------------------------------
    t_phase = time.perf_counter()
    res = sc1k.camera.width
    log(f"phase 29: Cornell {res}^2 x {BF16_SPP} spp depth 5 in RGB_BF16 and RGB, one call "
        f"[card: {card}]")
    frames = {}
    for policy in (RGB_BF16, RGB):
        cfg = PathConfig(spp=BF16_SPP, max_depth=5, dtypes=policy)
        img, ms, wall, peak = render_frame(render, scene1k, sc1k.camera, cfg, torch)
        ev, _ = device_events(lambda: render(scene1k, sc1k.camera, cfg, seed=0))
        reset_all(traversal)
        render(scene1k, sc1k.camera, cfg, seed=0)
        torch.cuda.synchronize()
        got = launches()
        frames[variant_string(policy)] = (img.cpu().numpy(), ms, len(ev), peak, got)
        frame_line(f"{variant_string(policy)} {res}^2 spp {BF16_SPP} depth 5", ms, wall, peak,
                   res, cfg, card)
        log(f"    CUDA launches {len(ev)}; traversal launches {got}")
        n_px = res * res
        chunk = max(1, min(cfg.spp, path_mod.MAX_RAYS_IN_FLIGHT // n_px))
        check(got == {"dense_intersect.closest": -(-cfg.spp // chunk) * (1 + cfg.max_depth)},
              f"{variant_string(policy)} launches {got}")
    bf, f32 = frames["rgb-bfloat16-float32"], frames["rgb-float32-float32"]
    delta = float(np.abs(bf[0] - f32[0]).mean() / np.abs(f32[0]).mean())
    log(f"  | variant | s/frame | CUDA launches | peak GiB | mean rel. image delta |")
    for name_, (_, ms, n_ev, peak, _) in frames.items():
        log(f"  | {name_} | {ms / 1e3:.4f} | {n_ev} | {peak:.3f} | "
            f"{delta if name_.startswith('rgb-bf') else 0.0:.6f} | [card: {card}]")
    check(0.0 < delta < BF16_DELTA_MAX, f"bf16 mean relative image delta {delta}")
    check_image(bf[0], res, "bf16 Cornell")
    out["bf16_dense_closest"] = bf[4]["dense_intersect.closest"]
    with tempfile.TemporaryDirectory() as tmp, log_records() as logbuf, \
            captured_write_png() as written:
        png = os.path.join(tmp, "bf16.png")
        reset_all(traversal)
        rc = cli_render.main(["-i", SCENE_FILE, "-o", png, "--device", "cuda", "--width", "256",
                              "--height", "256", "--spp", "4", "--max-depth", "5",
                              "--spectrum-dtype", "bfloat16"])
        check(rc == 0, f"CLI --spectrum-dtype bfloat16 returned {rc}")
        px = png_pixels(png)
    sc256 = cornell_box(256, 256)
    want = render(sc256.compile(device=dev), sc256.camera,
                  PathConfig(spp=4, max_depth=5, dtypes=RGB_BF16), seed=0).cpu().numpy()
    check("variant: rgb-bfloat16-float32" in logbuf.getvalue(), "the CLI did not log the variant")
    check(np.array_equal(written[0], want), "CLI bf16 image differs from render's")
    log(f"  CLI --spectrum-dtype bfloat16: variant logged, image equal to render's bit for "
        f"bit, PNG mean {px.mean():.1f}/255, launches {launches()}")
    sc64 = cornell_box(64, 64)
    img64 = render(sc64.compile(device=dev), sc64.camera,
                   PathConfig(spp=4, max_depth=5, dtypes=RGB_BF16), seed=0)
    images_match(img64.cpu().numpy(), np.load(BF16_GOLDEN))
    log(f"  phase 29: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 30: progressive, checkpointed, resumed ---------------------------------
    t_phase = time.perf_counter()
    cfg = PathConfig(spp=PROG_SPP, max_depth=5)
    chunk = 4
    n_chunks = PROG_SPP // chunk
    log(f"phase 30: render_progressive on phase 9's terrain n=1024, "
        f"{sc1m.camera.width}^2 x {PROG_SPP} spp depth 5, spp_chunk {chunk}, checkpoint every "
        f"4 chunks; stopped at {PROG_STOP} spp and resumed [card: {card}]")
    t0 = time.perf_counter()
    scene1m = host1m[0].to(dev)
    torch.cuda.synchronize()
    log(f"  phase 9's host compile copied to the card in {time.perf_counter() - t0:.2f} s")
    cam = sc1m.camera
    real_render, real_save = progressive.render, progressive.save_render_state
    chunk_s, save_s = [], []

    def timed_render(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img_ = real_render(*a, **k)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t)
        return img_

    class Preempted(Exception):
        pass

    def timed_save(path, acc, done, seed, meta, stop_at=None):
        t = time.perf_counter()
        real_save(path, acc, done, seed, meta)
        save_s.append(time.perf_counter() - t)
        if done == stop_at:
            raise Preempted

    kw = dict(seed=0, spp_chunk=chunk, checkpoint_every=4, progress=False)
    render_progressive(scene1m, cam, PathConfig(spp=chunk, max_depth=5), **kw)  # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        ck_a, ck_b = os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz")
        progressive.render, progressive.save_render_state = timed_render, timed_save
        try:
            reset_all(traversal)
            t0 = time.perf_counter()
            full = render_progressive(scene1m, cam, cfg, checkpoint_path=ck_a, **kw)
            full_s = time.perf_counter() - t0
            got_full = launches()
            per_chunk, saves = list(chunk_s), list(save_s)
            progressive.save_render_state = lambda *a: timed_save(*a, stop_at=PROG_STOP)
            try:
                render_progressive(scene1m, cam, cfg, checkpoint_path=ck_b, **kw)
                check(False, "the interrupted run was not stopped")
            except Preempted:
                pass
            check(load_render_state(ck_b)[1] == PROG_STOP, "no checkpoint at the stop")
            progressive.save_render_state = timed_save
            reset_all(traversal)
            resumed = render_progressive(scene1m, cam, cfg, checkpoint_path=ck_b, **kw)
            got_resumed = launches()
        finally:
            progressive.render, progressive.save_render_state = real_render, real_save
        one_pass = render_progressive(scene1m, cam, cfg, seed=0, spp_chunk=PROG_SPP,
                                      progress=False)
    log(f"  uninterrupted: {full_s:.3f} s wall, {n_chunks} chunks, per chunk median "
        f"{1e3 * float(np.median(per_chunk)):.2f} ms (min {1e3 * min(per_chunk):.2f}, max "
        f"{1e3 * max(per_chunk):.2f}); {len(saves)} checkpoints, write median "
        f"{1e3 * float(np.median(saves)):.2f} ms (max {1e3 * max(saves):.2f}); launches "
        f"{got_full} [card: {card}]")
    check(got_full == {"tree_intersect.closest": 6 * n_chunks},
          f"progressive launches {got_full}, expected 6 a chunk")
    check(got_resumed == {"tree_intersect.closest": 6 * (PROG_SPP - PROG_STOP) // chunk},
          f"resumed launches {got_resumed}")
    check(np.array_equal(resumed, full), "the resumed render differs from the uninterrupted one")
    np.testing.assert_allclose(one_pass, full, rtol=1e-5, atol=1e-6)
    check_image(full, cam.width, "progressive terrain n=1024")
    log(f"  resumed from {PROG_STOP} spp: bit-equal to the uninterrupted image, launches "
        f"{got_resumed}; one pass of {PROG_SPP} spp within rtol 1e-5, atol 1e-6 "
        f"(max |diff| {float(np.abs(one_pass - full).max()):.3g})")
    out["progressive_tree_closest"] = got_full["tree_intersect.closest"]
    del scene1m
    torch.cuda.empty_cache()
    log(f"  phase 30: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 31: the mesh cache and the importer -----------------------------------
    t_phase = time.perf_counter()
    log(f"phase 31: importer on the n=1024 terrain OBJ, then the CLI on the generated .akari "
        f"and on the OBJ scene, {cam.width}^2 x 4 spp [card: {card}]")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        obj_scene = write_terrain_obj(tmp, sc1m, cam.width, 4, 5)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(importer.main([os.path.join(tmp, "terrain.obj"), "-o",
                             os.path.join(tmp, "imported")]) == 0, "the importer failed")
        import_s = time.perf_counter() - t0
        cache_mb = os.path.getsize(os.path.join(tmp, "imported", "terrain.mesh.npz")) / 1e6
        with open(obj_scene) as f:
            text = f.read()
        obj_line = 'export mesh = AkariMesh { path: "terrain.obj" }\n'
        check(obj_line in text, "unexpected terrain scene text")
        cached_scene = os.path.join(tmp, "cached.akari")
        with open(cached_scene, "w") as f:
            f.write('import "imported/terrain.akari" as t\n'
                    + text.replace(obj_line, "export mesh = $t.mesh\n"))
        routes = {}
        for route, path in (("cache", cached_scene), ("obj", obj_scene)):
            meshcache.clear_cache()
            reset_all(traversal)
            with log_records() as logbuf, captured_write_png() as written:
                t0 = time.perf_counter()
                rc = cli_render.main(["-i", path, "-o", os.path.join(tmp, route + ".png"),
                                      "--device", "cuda"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            check(rc == 0, f"CLI on the {route} route returned {rc}")
            routes[route] = (written[0], wall, parsed_seconds(logbuf.getvalue()), launches())
    for route, (img, wall, parse, got) in routes.items():
        log(f"  {route} route: parse {parse:.3f} s, time to first image (CLI wall: parse + "
            f"compile + render + PNG) {wall:.2f} s, launches {got} [card: {card}]")
        check(got == {"tree_intersect.closest": 6}, f"{route} route launches {got}")
    log(f"  OBJ written in {write_s:.1f} s; importer {import_s:.2f} s "
        f"(OBJ parse + {cache_mb:.1f} MB compressed cache + .akari)")
    check(np.array_equal(routes["cache"][0], routes["obj"][0]),
          "the cached and OBJ routes give different images")
    check_image(routes["cache"][0], cam.width, "cached-mesh CLI")
    log("  the cached and OBJ routes' images are bit-equal")
    out["meshcache_tree_closest"] = routes["cache"][3]["tree_intersect.closest"]
    log(f"  phase 31: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 32: texel recovery ------------------------------------------------------
    t_phase = time.perf_counter()
    rres = RECOVERY_RES
    log(f"phase 32: textured Cornell {rres}^2 x 4 spp depth 3, texels and values at 0.4x: "
        f"{RECOVERY_ITERS} inverse_render iterations, optimize_images, log space "
        f"[card: {card}]")
    sct = textured_cornell_box(rres, rres)
    tscene = sct.compile(device=dev)
    cfg_t = PathConfig(spp=4, max_depth=3)
    with torch.no_grad():
        target = render(tscene, sct.camera, dataclasses.replace(cfg_t, spp=16), seed=777)
    tex = tscene.textures
    bad = dataclasses.replace(tscene, textures=dataclasses.replace(
        tex, value=tex.value * 0.4, images=tex.images * 0.4))
    with torch.no_grad():
        loss0 = float(loss_and_image(bad, sct.camera, cfg_t, target, seed=0)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, losses, _ = inverse_render(bad, sct.camera, cfg_t, target, InverseConfig(
        iterations=RECOVERY_ITERS, learning_rate=0.05, optimize_images=True, param_space="log"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        loss_end = float(loss_and_image(rec, sct.camera, cfg_t, target, seed=0)[0])
    log(f"  loss at seed 0: {loss0:.6g} -> {loss_end:.6g} ({loss_end / loss0:.4f}x, bound "
        f"{RECOVERY_LOSS_RATIO}); {1e3 * train_s / RECOVERY_ITERS:.2f} ms an iteration (wall) "
        f"[card: {card}]")
    check(loss_end < RECOVERY_LOSS_RATIO * loss0,
          f"texel recovery: loss {loss0} -> {loss_end}, bound {RECOVERY_LOSS_RATIO}x")

    def texel_step(scene_):
        p = scene_params(scene_, optimize_images=True)
        for v in p.values():
            v.requires_grad_(True)
        loss, _ = loss_and_image(apply_params(scene_, p), sct.camera, cfg_t, target)
        return loss, torch.autograd.grad(loss, [p["tex_value"], p["tex_images"]])

    step_q = event_quartiles(lambda: texel_step(bad))
    p = scene_params(bad, optimize_images=True)
    for v in p.values():
        v.requires_grad_(True)
    reset_all(traversal)
    fwd_ev, (loss_, _) = device_events(
        lambda: loss_and_image(apply_params(bad, p), sct.camera, cfg_t, target))
    fwd_l = launches()
    bwd_ev, _ = device_events(lambda: torch.autograd.grad(loss_, [p["tex_value"],
                                                                  p["tex_images"]]))
    check(launches() == fwd_l == {"dense_intersect.closest": 1 + cfg_t.max_depth},
          f"texel step launches: forward {fwd_l}, after the backward {launches()}")
    bwd_busy = sum(e.device_time_total for e in bwd_ev) / 1e3
    idx = [e for e in bwd_ev if "indexFunc" in e.name]
    index_add = sum(e.device_time_total for e in idx) / 1e3
    log(f"  texel step (fwd + bwd): median {step_q[1]:.3f} ms, quartiles {step_q[0]:.3f} / "
        f"{step_q[2]:.3f} ms (CUDA events); CUDA launches forward {len(fwd_ev)}, backward "
        f"{len(bwd_ev)}; traversal {fwd_l} in the forward, none in the backward; backward busy "
        f"{bwd_busy:.3f} ms, index_add {len(idx)} launches {index_add:.3f} ms "
        f"({index_add / max(bwd_busy, 1e-9):.3f} of it) [card: {card}]")
    out["texel_dense_closest"] = fwd_l["dense_intersect.closest"]
    gold = np.load(TEXGRAD_GOLDEN)
    w_, h_, spp_, depth_, seed_, tres_, tseed_ = (int(v) for v in gold["config"])
    sc64t = textured_cornell_box(w_, h_, tex_res=tres_, seed=tseed_)
    s64t = sc64t.compile(device=dev)
    cfg64 = PathConfig(spp=spp_, max_depth=depth_)
    zero = torch.zeros((h_, w_, 3), device=dev)

    def golden_step():
        p_ = scene_params(s64t, optimize_images=True)
        for v in p_.values():
            v.requires_grad_(True)
        loss, _ = loss_and_image(apply_params(s64t, p_), sc64t.camera, cfg64, zero, seed=seed_)
        return loss.detach(), torch.autograd.grad(loss, [p_["tex_value"], p_["tex_images"]])

    loss_k, (gv_k, gi_k) = golden_step()
    with plain_route(di):
        loss_p, (gv_p, gi_p) = golden_step()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    want_i = torch.from_numpy(gold["grad_tex_images"]).to(dev)
    want_v = torch.from_numpy(gold["grad_tex_value"]).to(dev)
    e_gold = max(rel(gi_k, want_i), rel(gv_k, want_v))
    e_plain = max(rel(gi_k, gi_p), rel(gv_k, gv_p))
    e_loss = abs(float(loss_k) - float(gold["loss"])) / float(gold["loss"])
    log(f"  64^2 texel gradient: vs the JAX package's max|diff| / max|g| {e_gold:.3e} (bound "
        f"{GOLDEN_GRAD_TOL}), loss relative {e_loss:.3e} (bound {GOLDEN_LOSS_RTOL}); kernel vs "
        f"plain route {e_plain:.3e} (bound {GRAD_TOL}), loss "
        f"{'bit-equal' if torch.equal(loss_k, loss_p) else 'DIFFERS'}")
    check(e_gold <= GOLDEN_GRAD_TOL and e_loss <= GOLDEN_LOSS_RTOL,
          f"texel gradient off the JAX package's: {e_gold}, loss {e_loss}")
    check(e_plain <= GRAD_TOL and torch.equal(loss_k, loss_p),
          f"texel gradient routes differ: {e_plain}")
    log(f"  phase 32: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 33: --profile ----------------------------------------------------------
    t_phase = time.perf_counter()
    log("phase 33: CLI --profile -v on the Cornell scene file, 256^2 x 4 spp")
    table = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, log_records() as logbuf:
        real_stderr = profiler.sys.stderr
        profiler.sys.stderr = table
        try:
            t0 = time.perf_counter()
            rc = cli_render.main(["-i", SCENE_FILE, "-o", os.path.join(tmp, "p.png"),
                                  "--device", "cuda", "--width", "256", "--height", "256",
                                  "--spp", "4", "--profile", "-v"])
            wall = time.perf_counter() - t0
        finally:
            profiler.sys.stderr = real_stderr
    check(rc == 0, f"CLI --profile returned {rc}")
    rows = table.getvalue().splitlines()
    log("  " + "\n  ".join(rows))
    spans = {r.split()[0]: float(r.split()[2]) for r in rows[1:]}
    check(set(spans) == {"render/path", "write_image"}, f"spans {sorted(spans)}")
    check(sum(spans.values()) / 1e3 <= wall, f"spans {spans} exceed the CLI wall {wall}")
    import re

    stamped = re.findall(r"^\[ *\d+\.\d{3}s (?:INFO|DEBUG)\] ", logbuf.getvalue(), re.M)
    check(len(stamped) >= 4, f"elapsed-stamped log lines: {len(stamped)}")
    log(f"  spans sum {sum(spans.values()):.2f} ms within the CLI wall {1e3 * wall:.2f} ms; "
        f"{len(stamped)} elapsed-stamped log lines")
    log(f"  phase 33: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---- phases 34-39: ray-sharded rendering over torch.distributed -----------------
# The rank workers below run in processes spawned by
# akari_torch.parallel.launch.spawn_ranks: each builds what it needs from its
# arguments (a spawned process starts from a fresh import) and returns plain
# values; the parent checks them.


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traversal():
    from akari_torch.ops import cluster_intersect, dense_intersect, instanced_tree_intersect
    from akari_torch.ops import tree_intersect

    return dense_intersect, tree_intersect, instanced_tree_intersect, cluster_intersect


def _rank_launches():
    """{"module.kernel": launches} of the traversal kernels in this rank."""
    return {f"{m.__name__.split('.')[-1]}.{n}": c for m in _traversal()
            for n, c in m.LAUNCHES.items() if c}


def _rank_reset():
    reset_all(_traversal())


def _sharded_step(mesh, scene, cam, cfg, target):
    """One fwd + bwd of the sharded bench loss through ``backward()``:
    (loss, image, d loss / d tex_value)."""
    from akari_torch.diff.inverse import apply_params, scene_params
    from akari_torch.parallel import loss_and_image_sharded

    p = scene_params(scene)
    p["tex_value"].requires_grad_(True)
    loss, img = loss_and_image_sharded(apply_params(scene, p), cam, cfg, mesh, target)
    loss.backward()
    return loss.detach(), img.detach(), p["tex_value"].grad


def _timed_steps(mesh, fn, iters, warmup):
    """Host seconds of fn() on every rank, each started together after a
    barrier and ended by a device sync, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters):
        _sync(mesh.device)
        mesh.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(mesh.device)
        out.append(time.perf_counter() - t0)
    return out


def _rank_compare(mesh, what, calls, name, mod, n_tris):
    """compare_kernel on this rank's kept launch ``calls.kept[name]``:
    (closest-hit max |diff|, any-hit max |diff|)."""
    import torch

    rays, args = calls.kept[name]
    with torch.no_grad():
        return compare_kernel(f"rank {mesh.rank} of {mesh.size}: {what}", rays, mod, args,
                              n_tris)[:2]


def bench_step_rank(mesh, res, iters, warmup, dryrun_res):
    """Phase 34 (and 37 with ``dryrun_res``) in one rank: the bench step
    sharded, its launches, its first fused dense launch against the plain
    version, step times and all-reduce times; then the dry run's bf16
    step on its two-level scene, its first fused instanced tree launch
    against the plain walk."""
    import torch

    from akari_torch.integrators.path import PathConfig
    from akari_torch.ops import dense_intersect, instanced_tree_intersect
    from akari_torch.scene import nodes
    from akari_torch.scene.builtin import cornell_box, dryrun_scene
    from akari_torch.utils.config import RGB_BF16

    dev = mesh.device
    sc = cornell_box(res, res)
    scene = sc.compile(intersector="auto", device=dev)
    cfg = PathConfig(spp=4, max_depth=5, mis=True, remat=False)
    target = torch.zeros((res, res, 3), device=dev)
    step = lambda: _sharded_step(mesh, scene, sc.camera, cfg, target)  # noqa: E731
    _sync(dev)
    mesh.barrier()
    _rank_reset()
    with kept_call(dense_intersect, ["closest"], keep=1) as calls:
        loss, img, g = step()
        _sync(dev)
    out = {"launches": _rank_launches(), "loss": float(loss), "image": img.cpu().numpy(),
           "grad": g.cpu().numpy(), "device": str(dev)}
    out["errs"] = _rank_compare(mesh, "bench step fused dense launch", calls, "closest",
                                dense_intersect, scene.n_tris)
    del calls
    out["step_s"] = _timed_steps(mesh, step, iters, warmup)
    n = res * res
    for name, numel in (("loss_and_film", 1 + 3 * n), ("gradient", g.numel())):
        t = torch.ones(numel, device=dev)
        out[f"all_reduce_{name}_s"] = _timed_steps(mesh, lambda: mesh.all_reduce(t), 20, 3)
    if dryrun_res:
        sd = dryrun_scene(dryrun_res, dryrun_res)
        old = nodes.FLATTEN_MAX_TRIS
        nodes.FLATTEN_MAX_TRIS = 1  # the dry run forces the two-level compile
        try:
            dscene = sd.compile(device=dev)
        finally:
            nodes.FLATTEN_MAX_TRIS = old
        dcfg = PathConfig(spp=4, max_depth=5, dtypes=RGB_BF16)
        dtarget = torch.zeros((dryrun_res, dryrun_res, 3), device=dev)
        _sync(dev)
        mesh.barrier()
        _rank_reset()
        with kept_call(instanced_tree_intersect, ["closest"], keep=1) as calls:
            dloss, _, dg = _sharded_step(mesh, dscene, sd.camera, dcfg, dtarget)
            _sync(dev)
        out["dryrun"] = {"launches": _rank_launches(), "loss": float(dloss),
                         "grad": dg.cpu().numpy(), "two_level": dscene.instances is not None}
        out["dryrun"]["errs"] = _rank_compare(mesh, "dry run fused instanced tree launch",
                                              calls, "closest", instanced_tree_intersect,
                                              dscene.n_tris)
    return out


def terrain_rank(mesh, n, res, bdpt_spp, prog_spp, prog_chunk, prog_stop, ckpt):
    """Phases 35-36 in one rank: the terrain compiled on the host and moved
    to this rank's device; BDPT (BASELINE config 5) sharded, its first
    connection group against the plain walk; then the progressive render
    sharded, uninterrupted, and preempted on every rank at ``prog_stop``
    samples (after the checkpoint there) and resumed
    (tests/_sharded_ranks.py), each chunk timed with its launches."""
    from collections import Counter

    from akari_torch.integrators import progressive
    from akari_torch.integrators.bdpt import BDPTConfig
    from akari_torch.integrators.path import PathConfig
    from akari_torch.ops import tree_intersect
    from akari_torch.parallel import render_sharded
    from akari_torch.scene.builtin import terrain_scene

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _sharded_ranks import progressive_resume

    dev = mesh.device
    t0 = time.perf_counter()
    sc = terrain_scene(res, res, n=n)
    scene = sc.compile(intersector="auto", device=dev)
    _sync(dev)
    out = {"compile_and_copy_s": time.perf_counter() - t0, "n_tris": scene.n_tris,
           "intersector": scene.intersector}
    cam = sc.camera
    render_sharded(scene, cam, BDPTConfig(spp=1), mesh)  # warm-up
    _sync(dev)
    mesh.barrier()
    _rank_reset()
    with kept_call(tree_intersect, ["any_hit"]) as calls:
        t0 = time.perf_counter()
        img = render_sharded(scene, cam, BDPTConfig(spp=bdpt_spp), mesh)
        _sync(dev)
        out["bdpt_s"] = time.perf_counter() - t0
    out["bdpt_launches"] = _rank_launches()
    out["bdpt_image"] = img.cpu().numpy()
    out["bdpt_group_rays"] = calls.sizes["any_hit"]
    out["bdpt_errs"] = _rank_compare(mesh, "BDPT connection group", calls, "any_hit",
                                     tree_intersect, scene.n_tris)
    del img, calls

    chunks = []  # (seconds, launches) of each chunk the three runs render
    shard = progressive.render_sharded

    def timed_chunk(*a, **k):
        _sync(dev)
        _rank_reset()
        t0 = time.perf_counter()
        r = shard(*a, **k)
        _sync(dev)
        chunks.append((time.perf_counter() - t0, _rank_launches()))
        return r

    kw = dict(seed=0, spp_chunk=prog_chunk, checkpoint_every=1, progress=False)
    mesh.barrier()
    progressive.render_sharded = timed_chunk
    try:
        full, resumed, writes, offsets = progressive_resume(
            mesh, scene, cam, PathConfig(spp=prog_spp, max_depth=5), ckpt, prog_stop, kw)
    finally:
        progressive.render_sharded = shard
    n_full, n_rest = prog_spp // prog_chunk, len(chunks) - len(offsets)

    def total(cs):
        return dict(sum((Counter(c) for _, c in cs), Counter()))

    out.update(chunk_s=[t for t, _ in chunks[:n_full]], chunk_launches=[c for _, c in chunks],
               progressive_launches=total(chunks[:n_full]),
               resume_launches=total(chunks[n_rest:]), progressive_image=full,
               resumed_image=resumed, writes=writes, resumed_offsets=offsets)
    return out


def run_together(jobs, tmp):
    """{name: (rc, stdout, stderr)} of ``python <argv>`` for each job, all
    started at once from the repository root (their output in files under
    ``tmp``); every job must exit 0 within ``SHARD_TIMEOUT_S``, and none
    outlives the call."""
    procs, files = {}, []
    try:
        for name, argv in jobs.items():
            out = open(os.path.join(tmp, name + ".out"), "w+")
            err = open(os.path.join(tmp, name + ".err"), "w+")
            files += [out, err]
            procs[name] = (subprocess.Popen([sys.executable] + argv, cwd=ROOT, stdout=out,
                                            stderr=err, text=True), out, err)
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        done = {}
        for name, (p, out, err) in procs.items():
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            out.seek(0)
            err.seek(0)
            done[name] = (rc, out.read(), err.read())
            check(rc == 0, f"{name} failed (rc {rc}):\n{done[name][2][-3000:]}")
        return done
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()


def sharded_phases(dev, card, sc, bdpt_image, cli_render, sizes):
    """Phases 34-39, ray-sharded rendering over torch.distributed: ranks are
    spawned processes (``spawn_ranks``); R = 1 over NCCL and R = 2 ranks
    sharing the one card over gloo (NCCL refuses two ranks on one GPU;
    NCCL across two or more cards is not exercised here). Returns the
    figures the log's summary needs."""
    import io

    import numpy as np
    import torch

    from akari_torch.integrators.bdpt import BDPTConfig
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.parallel.launch import rank_route, spawn_ranks

    s = SimpleNamespace(**sizes)
    cuda = dev.type == "cuda"  # False only in a rehearsal on the CPU (no launch counts)
    out = {}
    torch.cuda.empty_cache()

    def spawn(fn, world, args):
        device, backend, _ = rank_route(dev.type, world)
        return spawn_ranks(fn, world, args, device=device, backend=backend,
                           timeout=SHARD_TIMEOUT_S, threads=None if cuda else 1)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def median_ms(ts):
        return 1e3 * float(np.median(ts))

    # ---- phase 34: the bench step, sharded ----------------------------------------
    t_phase = time.perf_counter()
    res = s.step_res
    log(f"phase 34: the bench step sharded (loss_and_image_sharded, cornell {res}^2, 4 spp, "
        f"depth 5): R = 1 over {rank_route(dev.type, 1)[1]}, R = 2 over "
        f"{rank_route(dev.type, 2)[1]} [card: {card}]")
    scene = sc.compile(intersector="auto", device=dev)
    cfg = PathConfig(spp=4, max_depth=5, mis=True, remat=False)
    target = torch.zeros((res, res, 3), device=dev)
    loss_u, g_u = bench_step(scene, sc.camera, cfg, target)
    loss_u, g_u = float(loss_u), g_u.cpu().numpy()
    with torch.no_grad():  # the bench loss's image is the render's, bit for bit
        img_u = render(scene, sc.camera, cfg).cpu().numpy()
    runs = {1: spawn(bench_step_rank, 1, (res, 10, 2, 0)),
            2: spawn(bench_step_rank, 2, (res, 10, 2, s.dryrun_res))}
    for world, ranks in runs.items():
        r0 = ranks[0]
        for r in ranks[1:]:
            check(r["loss"] == r0["loss"] and np.array_equal(r["grad"], r0["grad"])
                  and np.array_equal(r["image"], r0["image"]),
                  f"R = {world}: ranks disagree")
        loss_rel = abs(r0["loss"] - loss_u) / loss_u
        g_rel = rel(r0["grad"], g_u)
        img_equal = np.array_equal(r0["image"], img_u)
        img_diff = float(np.abs(r0["image"] - img_u).max())
        steps = [max(t) for t in zip(*(r["step_s"] for r in ranks))]
        ar = {k: median_ms([max(t) for t in zip(*(r[f"all_reduce_{k}_s"] for r in ranks))])
              for k in ("loss_and_film", "gradient")}
        log(f"  R = {world} on {[r['device'] for r in ranks]}: loss {r0['loss']:.8g} (unsharded "
            f"{loss_u:.8g}, rel {loss_rel:.2e}); gradient max|diff| / max|g| {g_rel:.2e}, "
            f"bit-equal across ranks; image {'bit-equal to' if img_equal else 'DIFFERS from'} "
            f"the unsharded (max |diff| {img_diff:.3e})")
        log(f"    dense launches per rank {[r['launches'] for r in ranks]}; step median "
            f"{median_ms(steps):.3f} ms, quartiles {1e3 * np.percentile(steps, 25):.3f} / "
            f"{1e3 * np.percentile(steps, 75):.3f} ms (host clock to a device sync, the "
            f"slowest rank, 10 after 2 warm-ups); all-reduce medians: loss + film "
            f"({1 + 3 * res * res} floats) {ar['loss_and_film']:.3f} ms, gradient "
            f"({r0['grad'].size} floats) {ar['gradient']:.3f} ms [card: {card}]")
        check(loss_rel <= 1e-5, f"R = {world}: loss rel {loss_rel}")
        check(g_rel <= 1e-5, f"R = {world}: gradient rel {g_rel}")
        check(np.allclose(r0["image"], img_u, rtol=1e-5, atol=1e-5), f"R = {world}: image")
        if cuda:
            check(all(r["launches"] == {"dense_intersect.closest": 1 + cfg.max_depth}
                      for r in ranks), f"R = {world}: launches {[r['launches'] for r in ranks]}")
        errs = [r["errs"] for r in ranks]
        log(f"    each rank's first fused dense launch against the plain version: prims and "
            f"any-hit exact, t/u/v max |diff| {max(e[0] for e in errs):.3g}")
        out["dense_errs"] = [max(a) for a in zip(out.get("dense_errs", (0.0, 0.0)), *errs)]
        out[f"step_ms_r{world}"] = median_ms(steps)
        out[f"step_dense_launches_r{world}"] = ranks[0]["launches"].get(
            "dense_intersect.closest", 0)
    log(f"  phase 34: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 35-36: BASELINE config 5 and progressive, sharded ------------------
    t_phase = time.perf_counter()
    log(f"phase 35: render_sharded(terrain n={s.terrain_n} {s.terrain_res}^2, "
        f"BDPTConfig(spp={s.bdpt_spp})), R = 2 over {rank_route(dev.type, 2)[1]} [card: {card}]")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(terrain_rank, 2,
                      (s.terrain_n, s.terrain_res, s.bdpt_spp, s.prog_spp, s.prog_chunk,
                       s.prog_stop, os.path.join(tmp, "render.npz")))
    r0 = ranks[0]
    for r in ranks[1:]:
        check(np.array_equal(r["bdpt_image"], r0["bdpt_image"]), "BDPT: ranks disagree")
    bimg = r0["bdpt_image"]
    diff = np.abs(bimg - bdpt_image)
    splat_rel = float(diff.max() / np.abs(bdpt_image).max())
    per_sample = BDPTConfig().eye_depth + BDPTConfig().light_depth - 1
    log(f"  {r0['n_tris']} tris on {r0['intersector']}, host compile + copy "
        f"{[round(r['compile_and_copy_s'], 2) for r in ranks]} s; frame "
        f"{[round(r['bdpt_s'], 3) for r in ranks]} s wall per rank [card: {card}]")
    errs = [r["bdpt_errs"] for r in ranks]
    log(f"  each rank's first connection group ({[r['bdpt_group_rays'][0] for r in ranks]} rays) "
        f"against the plain walk: prims and any-hit exact, t/u/v max |diff| "
        f"{max(e[0] for e in errs):.3g}")
    out["tree_errs"] = [max(a) for a in zip(*errs)]
    log(f"  tree launches per rank {[r['bdpt_launches'] for r in ranks]}; against phase 26's "
        f"unsharded image: max |diff| {float(diff.max()):.3e}, / max|image| {splat_rel:.3e} "
        f"(splat bound {SPLAT_TOL}), radiance-only pixels "
        f"{'bit-equal' if np.array_equal(bimg, bdpt_image) else 'differ where splats land'}")
    check(np.allclose(bimg, bdpt_image, rtol=1e-5, atol=1e-5), "sharded BDPT != phase 26's")
    check(splat_rel <= SPLAT_TOL, f"sharded BDPT splat off by {splat_rel}")
    check_image(bimg, s.terrain_res, "sharded BDPT terrain")
    if cuda:
        for r in ranks:
            got = r["bdpt_launches"]
            check(got.get("tree_intersect.closest") == s.bdpt_spp * per_sample
                  and got.get("tree_intersect.any_hit") == s.bdpt_spp,
                  f"sharded BDPT launches {got}")
    out["bdpt_s"] = max(r["bdpt_s"] for r in ranks)
    out["bdpt_launches"] = r0["bdpt_launches"]
    log(f"phase 36: render_progressive(mesh=...) on the same ranks: {s.prog_spp} spp in "
        f"chunks of {s.prog_chunk}, preempted at {s.prog_stop} and resumed")
    n_chunks = s.prog_spp // s.prog_chunk
    for i, r in enumerate(ranks):
        check(np.array_equal(r["resumed_image"], r["progressive_image"]),
              f"rank {i}: resumed != uninterrupted")
        check(np.array_equal(r["progressive_image"], r0["progressive_image"]),
              f"rank {i}: progressive image differs from rank 0's")
        want = list(range(s.prog_chunk, s.prog_stop + 1, s.prog_chunk)) + list(
            range(s.prog_stop + s.prog_chunk, s.prog_spp + 1, s.prog_chunk))
        check(r["writes"] == (want if i == 0 else []), f"rank {i} wrote {r['writes']}")
        check(r["resumed_offsets"] == list(range(s.prog_stop, s.prog_spp, s.prog_chunk)),
              f"rank {i}: the resumed run rendered from {r['resumed_offsets']}")
        if cuda:  # the uninterrupted, the preempted and the resumed runs' chunks
            check(r["chunk_launches"] == [{"tree_intersect.closest": 6}] * (
                n_chunks + s.prog_stop // s.prog_chunk + len(r["resumed_offsets"])),
                f"rank {i}: progressive chunk launches {r['chunk_launches']}")
    check_image(r0["progressive_image"], s.terrain_res, "sharded progressive terrain")
    log(f"  resumed == uninterrupted bit for bit on every rank; writes "
        f"{[r['writes'] for r in ranks]}; chunks "
        f"{[[round(1e3 * t, 1) for t in r['chunk_s']] for r in ranks]} ms; launches "
        f"{[r['progressive_launches'] for r in ranks]}, resumed "
        f"{[r['resume_launches'] for r in ranks]} [card: {card}]")
    out["progressive_launches"] = r0["progressive_launches"]
    log(f"  phases 35-36: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 37: the dry run's step (from phase 34's R = 2 ranks) ----------------
    log(f"phase 37: the multi-device dry run's step (two-level instanced floor, env map, "
        f"bf16, 4 spp, depth 5) at {s.dryrun_res}^2, R = 2 against R = 1")
    from akari_torch.parallel import make_ray_mesh
    from akari_torch.scene.builtin import dryrun_scene
    from akari_torch.utils.config import RGB_BF16

    sd = dryrun_scene(s.dryrun_res, s.dryrun_res)
    with flatten_max_tris(1):
        dscene = sd.compile(device=dev)
    check(dscene.instances is not None, "the dry run did not compile two-level")
    dcfg = PathConfig(spp=4, max_depth=5, dtypes=RGB_BF16)
    one = _sharded_step(make_ray_mesh(dev), dscene, sd.camera, dcfg,
                        torch.zeros((s.dryrun_res, s.dryrun_res, 3), device=dev))
    d = [r["dryrun"] for r in runs[2]]
    d_loss_rel = abs(d[0]["loss"] - float(one[0])) / float(one[0])
    d_g_rel = rel(d[0]["grad"], one[2].cpu().numpy())
    log(f"  loss {d[0]['loss']:.8g} (R = 1 {float(one[0]):.8g}, rel {d_loss_rel:.2e}); gradient "
        f"max|diff| / max|g| {d_g_rel:.2e}; instanced tree launches per rank "
        f"{[x['launches'] for x in d]}; each rank's first fused launch against the plain "
        f"walk: prims and any-hit exact, t/u/v max |diff| {max(x['errs'][0] for x in d):.3g}")
    out["instanced_tree_errs"] = [max(a) for a in zip(*(x["errs"] for x in d))]
    check(all(x["two_level"] for x in d), "a rank did not compile the dry run two-level")
    check(np.isfinite(d[0]["loss"]) and np.isfinite(d[0]["grad"]).all(), "dry run not finite")
    check(d[1]["loss"] == d[0]["loss"] and np.array_equal(d[1]["grad"], d[0]["grad"]),
          "dry run: ranks disagree")
    check(d_loss_rel <= 1e-6 and d_g_rel <= 1e-5, f"dry run: loss {d_loss_rel}, grad {d_g_rel}")
    if cuda:
        check(all(x["launches"] == {"instanced_tree_intersect.closest": 6} for x in d),
              f"dry run launches {[x['launches'] for x in d]}")

    # ---- phases 38-39: the CLI under torchrun and the tools ------------------------
    # The torchrun CLI and the two distributed checks only check results, so
    # their processes run together (each starts torch and reaches the card
    # on its own); the scaling bench measures, so it runs alone after them.
    t_phase = time.perf_counter()
    log("phase 38: CLI --sharded under torch.distributed.run --nproc-per-node=1 "
        f"({rank_route(dev.type, 1)[1]}) against the unsharded CLI; phase 39: "
        "tools/distributed_check_torch.py at R = 1, 2 beside it, then bench_scaling_torch.py "
        "at R = 1, 2 alone")
    with tempfile.TemporaryDirectory() as tmp:
        args = ["-i", SCENE_FILE, "--device", dev.type] + s.cli_args
        sharded, plain = os.path.join(tmp, "sharded.png"), os.path.join(tmp, "plain.png")
        jobs = {
            "cli": ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
                    "-m", "akari_torch.cli.render", "--sharded", "-v", "-o", sharded] + args,
            "check_r1": ["tools/distributed_check_torch.py", "--ranks", "1", "--device", dev.type],
            "check_r2": ["tools/distributed_check_torch.py", "--ranks", "2", "--device", dev.type],
        }
        done = run_together(jobs, tmp)
        check(cli_render.main(args + ["-o", plain]) == 0, "unsharded CLI failed")
        check("rank 0 of 1" in done["cli"][2], "the CLI did not render on a ray mesh")
        with open(sharded, "rb") as f1, open(plain, "rb") as f2:
            same = f1.read() == f2.read()
        px = png_pixels(sharded)
    log(f"  torchrun CLI PNG {'equal to' if same else 'DIFFERS from'} the unsharded CLI's, "
        f"mean {px.mean():.1f}/255")
    check(same, "sharded CLI image != unsharded CLI image")
    import bench_scaling_torch

    scaling = io.StringIO()
    with contextlib.redirect_stdout(scaling):
        check(bench_scaling_torch.main(["--device", dev.type]) == 0, "bench_scaling_torch failed")
    for name, text in (("check_r1", done["check_r1"][1]), ("check_r2", done["check_r2"][1]),
                       ("bench_scaling", scaling.getvalue())):
        for line in text.strip().splitlines():
            log(line)
            check(json.loads(line).get("ok", True), f"{name}: {line}")
    log(f"  phases 38-39: {time.perf_counter() - t_phase:.1f} s")
    return out


def aos_routes(label, scene, o, d, mod, traversal):
    """The AoS ``intersect`` / ``occlude`` on [N, 3] rays through the
    scene's kernel (one closest and one any-hit launch, no other traversal
    launch) and through its plain version (``plain_route``): prims and
    occlusion exact, t/u/v within 2 ulp. Returns (closest max |diff|,
    any-hit max |diff|)."""
    import torch

    from akari_torch.ops.intersect import intersect, occlude

    far = torch.full((o.shape[0],), 1e3, device=o.device)
    torch.cuda.synchronize()
    reset_all(traversal)
    h = intersect(scene, o, d)
    occ = occlude(scene, o, d, 0.0, far)
    torch.cuda.synchronize()
    launches = dict(mod.LAUNCHES)
    check(launches == {"closest": 1, "any_hit": 1} and others(traversal, mod) == 0,
          f"{label}: launches {launches}, others {others(traversal, mod)}")
    with plain_route(mod):
        hp = intersect(scene, o, d)
        occ_p = occlude(scene, o, d, 0.0, far)
    check(torch.equal(h.prim, hp.prim) and torch.equal(h.valid, hp.valid),
          f"{label}: prim differs on {int((h.prim != hp.prim).sum())} rays")
    ok = h.valid
    pairs = ((h.t, hp.t), (h.uv[:, 0], hp.uv[:, 0]), (h.uv[:, 1], hp.uv[:, 1]))
    max_ulp = max(ulp_diff(a[ok], b[ok]) for a, b in pairs)
    err = max(float((a - b).abs().max()) for a, b in pairs)
    check(max_ulp <= 2, f"{label}: t/u/v differ by {max_ulp} ulp")
    check(torch.equal(occ, occ_p), f"{label}: occlude through the kernel != plain")
    log(f"  {label}: {o.shape[0]} rays, {int(ok.sum())} hits, launches {launches}; "
        f"kernel == plain: prims exact, t/u/v max |diff| {err:.3g} ({max_ulp} ulp), "
        f"{int(occ.sum())} occluded within 1e3, equal")
    return err, float((occ.float() - occ_p.float()).abs().max())


def bench_phase(dev, card, traversal, scene, sc, scene512, sc512, bench_loss):
    """Phase 40: ``bench_torch.primary`` in this process, then the AoS
    entry points of its per-stage table on every tree route against their
    plain versions; returns {"dense" | "tree" | "instanced_tree": (closest
    error, any-hit error)}."""
    import torch

    import bench_torch
    from akari_torch.integrators.path import camera_rays
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import instanced_tree_intersect as iti
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.scene.builtin import instanced_bench_scene

    t_phase = time.perf_counter()
    log(f"phase 40: bench_torch.primary in process (the port's bench step, sharded over a "
        f"1-rank ray mesh), then the per-stage table's intersect / occlude on every route "
        f"[card: {card}]")
    torch.cuda.synchronize()
    reset_all(traversal)
    run = bench_torch.primary(dev)
    torch.cuda.synchronize()
    launches = dict(di.LAUNCHES)
    steps = 1 + bench_torch.WARMUP + bench_torch.ITERS
    lines = run.lines()
    for line in lines:
        log(f"  {line}")
    last = json.loads(lines[-1])
    check(list(last) == ["metric", "value", "unit", "vs_baseline"], f"bench keys {list(last)}")
    check(last["metric"] == "rays_per_sec_per_chip_fwd_bwd_4spp_cornell"
          and last["value"] > 0, f"bench result {last}")
    log(f"  dense launches over its {steps} steps: {launches}; loss "
        f"{'bit-equal to' if torch.equal(run.loss, bench_loss) else 'DIFFERS from'} "
        f"phase 19's unsharded step ({float(run.loss):.8g})")
    check(launches == {"closest": 6 * steps, "any_hit": 0} and others(traversal, di) == 0,
          f"bench launches {launches}")
    check(torch.equal(run.loss, bench_loss), "the bench loss differs from phase 19's")
    check(bool(torch.isfinite(run.grad).all()), "non-finite bench gradient")

    sc_b = instanced_bench_scene(256, 256)
    with flatten_max_tris(1):
        bench64 = sc_b.compile(device=dev)

    def cam_rays(cam):
        n = cam.width * cam.height
        pix = torch.arange(n, dtype=torch.int64, device=dev)
        return camera_rays(cam, 0, torch.zeros_like(pix), pix)

    # instanced-bench64's camera sees none of its instances (its frame is
    # black): rays from above each instance down onto it follow the camera's
    o, d = cam_rays(sc_b.camera)
    g = torch.Generator(device=dev).manual_seed(11)
    n_down = o.shape[0]
    o2w = bench64.instances.o2w
    at = o2w[torch.randint(0, o2w.shape[0], (n_down,), generator=g, device=dev), :, 3]
    u = torch.rand((n_down, 4), generator=g, device=dev) * 2.0 - 1.0
    zero = torch.zeros_like(u[:, 0])
    o_down = at + torch.stack([u[:, 0], zero + 2.0, u[:, 1]], 1)
    d_down = at + torch.stack([u[:, 2], zero, u[:, 3]], 1) - o_down
    d_down = d_down / d_down.norm(dim=1, keepdim=True)
    errs = {}
    for key, label, scene_, (o_, d_), mod in (
            ("dense", "dense (Cornell, 36 tris)", scene, cam_rays(sc.camera), di),
            ("tree", f"tree (terrain512, {scene512.n_tris} tris)", scene512,
             cam_rays(sc512.camera), ti),
            ("instanced_tree", f"instanced tree (instanced-bench64, {bench64.n_tris} world "
             f"tris; camera rays, then as many down onto the instances)", bench64,
             (torch.cat([o, o_down]), torch.cat([d, d_down])), iti)):
        errs[key] = aos_routes(label, scene_, o_, d_, mod, traversal)
    log(f"  phase 40: {time.perf_counter() - t_phase:.1f} s")
    return errs


@functools.lru_cache(maxsize=1)
def albedo_png():
    """Phase 24's albedo.png (the config-3 albedo, ``ENVTEX_FULL``'s texture
    size) and the PNG route's pixels of it (read-only), made once for
    phases 41-51."""
    from akari_torch.core.image import decode_png, encode_png
    from akari_torch.scene.builtin import envtex_texture

    png = encode_png(envtex_texture(ENVTEX_FULL["tex_res"], 0))
    px = decode_png(png)
    px.setflags(write=False)
    return png, px


def _median_s(fn, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2], times


@functools.lru_cache(maxsize=1)
def png_decode_median():
    """The 2048^2 PNG route's decode time (``albedo_png``'s file), median
    of 3 and the runs, taken once in phase 41: phases 42-53 hold their
    decoders "no slower than PNG" against it."""
    from akari_torch.core.image import decode_png

    return _median_s(lambda: decode_png(albedo_png()[0]))


def image_phase(card, traversal, cli_render):
    """Phase 41: the port's JPEG and PNG decoders on this machine (no PIL
    here): the fixtures' digests, the 2048^2 decode times, and the config-3
    CLI with a JPEG albedo against the same CLI on a lossless PNG of its
    decoded pixels; returns the figures it logs."""
    import hashlib

    import numpy as np
    import torch

    from akari_torch.core.image import decode_png, encode_png
    from akari_torch.core.jpeg import decode_jpeg
    from akari_torch.integrators import path as path_mod
    from akari_torch.scene.builtin import write_envtex_terrain

    t_phase = time.perf_counter()
    log(f"phase 41: image decoding without PIL: the fixtures' digests, the 2048^2 JPEG and PNG "
        f"decodes, the config-3 CLI on a JPEG albedo [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items() if k.endswith((".jpg", ".png"))}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            data = f.read()
        px = decode_jpeg(data, fname) if fname.endswith(".jpg") else decode_png(data, fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL's in digests.json")
    with open(os.path.join(IMAGE_FIXTURES, ALBEDO_JPEG), "rb") as f:
        jpeg_data = f.read()
    png_data = albedo_png()[0]  # phase 24's albedo.png
    jpeg_s, jpeg_all = _median_s(lambda: decode_jpeg(jpeg_data))
    png_s, png_all = png_decode_median()
    log(f"  2048^2 decode on the host, median of 3: JPEG {jpeg_s:.3f} s ({len(jpeg_data)} bytes; "
        f"runs {', '.join(f'{t:.3f}' for t in jpeg_all)}), PNG {png_s:.3f} s ({len(png_data)} "
        f"bytes; runs {', '.join(f'{t:.3f}' for t in png_all)}) [card: {card}]")
    # one more JPEG decode with its numpy stages timed: the rest is the
    # marker parse and the native entropy decoding
    from akari_torch.core import jpeg as jpeg_mod

    stage_s = {}

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            stage_s[fn.__name__] = stage_s.get(fn.__name__, 0.0) + time.perf_counter() - t0
            return r
        return run

    real = {n: getattr(jpeg_mod, n) for n in ("_idct_islow", "_upsample", "_ycc_to_rgb")}
    for n, fn in real.items():
        setattr(jpeg_mod, n, timed(fn))
    try:
        t0 = time.perf_counter()
        decode_jpeg(jpeg_data)
        total_s = time.perf_counter() - t0
    finally:
        for n, fn in real.items():
            setattr(jpeg_mod, n, fn)
    log(f"  one JPEG decode split: {total_s:.3f} s = markers + entropy (native) "
        f"{total_s - sum(stage_s.values()):.3f} s, IDCT {stage_s['_idct_islow']:.3f} s, "
        f"upsampling {stage_s['_upsample']:.3f} s, colour {stage_s['_ycc_to_rgb']:.3f} s")

    full = ENVTEX_FULL
    cfg_spp, depth = full["spp"], full["depth"]
    chunk = max(1, min(cfg_spp, path_mod.MAX_RAYS_IN_FLIGHT // full["res"] ** 2))
    expect = {"tree_intersect.closest": -(-cfg_spp // chunk) * (1 + depth)}
    out = {"jpeg_decode_s": jpeg_s, "png_decode_s": png_s}
    with tempfile.TemporaryDirectory() as tmp:
        akari = write_envtex_terrain(tmp, **full)
        with open(os.path.join(tmp, "albedo.jpg"), "wb") as f:
            f.write(jpeg_data)
        with open(os.path.join(tmp, "decoded.png"), "wb") as f:
            f.write(encode_png(decode_jpeg(jpeg_data)))
        mtl = os.path.join(tmp, "terrain.mtl")
        with open(mtl) as f:
            mtl_text = f.read()
        # the routes alternate, so that neither owns a position in the process
        frames, route_s = [], {"albedo.jpg": [], "decoded.png": []}
        for run, albedo in enumerate(("decoded.png", "albedo.jpg", "decoded.png", "albedo.jpg")):
            with open(mtl, "w") as f:
                f.write(mtl_text.replace("map_Kd albedo.png", f"map_Kd {albedo}"))
            reset_all(traversal)
            with log_records() as logbuf, captured_write_png() as written:
                t0 = time.perf_counter()
                rc = cli_render.main(["-i", akari, "-o", os.path.join(tmp, f"cli{run}.png"),
                                      "--device", "cuda", "-v"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got = {f"{m.__name__.split('.')[-1]}.{n}": c for m in traversal
                   for n, c in m.LAUNCHES.items() if c}
            check(rc == 0, f"CLI on {albedo} returned {rc}")
            check(got == expect, f"CLI on {albedo}: launches {got}, expected {expect}")
            parse_s = parsed_seconds(logbuf.getvalue())
            frames.append(np.asarray(written[-1]))
            check_image(frames[-1], full["res"], f"CLI on {albedo}")
            log(f"  CLI with map_Kd {albedo}: time to first image {wall:.3f} s wall (parse OBJ + "
                f"MTL + texture + sky {parse_s:.3f} s), launches {got} [card: {card}]")
            out[f"cli_{run}_s"], out[f"parse_{run}_s"] = wall, parse_s
            route_s[albedo].append(wall)
    check(all(np.array_equal(frames[0], f) for f in frames[1:]),
          "the JPEG-albedo frame differs from the lossless PNG route's")
    log("  the JPEG-albedo frames are bit-equal to the frames on the PNG of their decoded pixels")
    jpeg_runs, png_runs = route_s["albedo.jpg"], route_s["decoded.png"]
    log(f"  time to first image by route (runs in order PNG, JPEG, PNG, JPEG): JPEG "
        f"{min(jpeg_runs):.3f}-{max(jpeg_runs):.3f} s, PNG {min(png_runs):.3f}-{max(png_runs):.3f} s;"
        f" JPEG minus the PNG run before it: "
        f"{', '.join(f'{j - p:+.3f}' for j, p in zip(jpeg_runs, png_runs))} s [card: {card}]")
    log(f"  phase 41: {time.perf_counter() - t_phase:.1f} s")
    return out


def albedo_files(px, torch=None):
    """The config-3 albedo's pixels [H, W, 3] uint8 as TGA (bottom-left),
    TGA-RLE (literal packets of 128 pixels, across scanlines), a 24-bit
    BMP, a P6 PPM, a PackBits RGB PSD, and a GIF of the pixels quantised
    to 3-3-2 bits (256 colours; every pixel one 9-bit literal code, a clear
    code each 253 codes, so that the table never grows to 10 bits): the
    file bytes, and the GIF's expected pixels."""
    import struct

    import numpy as np

    h, w, _ = px.shape
    bgr_up = np.ascontiguousarray(px[::-1, :, ::-1]).reshape(-1, 3)
    files = {}
    files["tga"] = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0) \
        + bgr_up.tobytes()
    n = bgr_up.shape[0]  # a multiple of 128 here
    packets = np.concatenate([np.full((n // 128, 1), 127, np.uint8),
                              bgr_up.reshape(n // 128, 384)], axis=1)
    files["tga_rle"] = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24, 0) \
        + packets.tobytes()
    row = -(-3 * w // 4) * 4
    rows = np.zeros((h, row), np.uint8)
    rows[:, :3 * w] = px[::-1, :, ::-1].reshape(h, -1)
    files["bmp"] = b"BM" + struct.pack("<IHHIIiiHHIIiiII", 54 + rows.size, 0, 0, 54, 40, w, h,
                                       1, 24, 0, rows.size, 2835, 2835, 0, 0) + rows.tobytes()
    files["ppm"] = f"P6\n{w} {h}\n255\n".encode() + px.tobytes()
    planes = np.moveaxis(px, 2, 0).reshape(3 * h, w // 128, 128)
    lit = np.concatenate([np.full((3 * h, w // 128, 1), 127, np.uint8), planes], axis=2)
    files["psd"] = (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, h, w, 8, 3) + bytes(12)
                    + struct.pack(">H", 1) + struct.pack(f">{3 * h}H", *[lit[0].size] * (3 * h))
                    + lit.tobytes())
    idx = (px[..., 0] >> 5).astype(np.int64) << 5 | (px[..., 1] >> 5) << 2 | px[..., 2] >> 6
    i = np.arange(256)
    pal = np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7, (i & 3) * 85], 1)
    flat = idx.reshape(-1)
    k = 253
    chunks = -(-flat.size // k)
    body = np.full(chunks * k, -1, np.int64)
    body[:flat.size] = flat
    codes = np.concatenate([np.full((chunks, 1), 256), body.reshape(chunks, k)], axis=1)
    codes = np.append(codes[codes >= 0], 257)
    bits = ((codes.astype(np.uint16)[:, None] >> np.arange(9, dtype=np.uint16)) & 1)
    bits = bits.astype(np.uint8).reshape(-1)
    lzw = np.packbits(bits, bitorder="little")
    full = lzw.size // 255
    blocks = np.concatenate([np.full((full, 1), 255, np.uint8),
                             lzw[:full * 255].reshape(full, 255)], axis=1).tobytes()
    tail = lzw[full * 255:]
    blocks += (bytes([tail.size]) + tail.tobytes() if tail.size else b"") + b"\x00"
    files["gif"] = (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
                    + pal.astype(np.uint8).tobytes()
                    + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08" + blocks + b";")
    return files, pal.astype(np.uint8)[idx]


def _huffman_lengths(counts, max_len):
    """Code lengths of a Huffman code for ``counts`` (symbols of count 0
    get 0), no longer than ``max_len`` (the counts are halved until the
    tree fits)."""
    import heapq

    import numpy as np

    counts = np.asarray(counts, np.int64)
    while True:
        used = np.flatnonzero(counts)
        lengths = np.zeros(counts.size, np.int64)
        if used.size == 1:
            lengths[used] = 1
            return lengths
        heap = [(int(counts[s]), int(s), [int(s)]) for s in used]
        heapq.heapify(heap)
        while len(heap) > 1:
            c1, k1, s1 = heapq.heappop(heap)
            c2, k2, s2 = heapq.heappop(heap)
            lengths[s1 + s2] += 1
            heapq.heappush(heap, (c1 + c2, min(k1, k2), s1 + s2))
        if lengths.max() <= max_len:
            return lengths
        counts = np.where(counts > 0, (counts + 1) // 2, 0)


def _canonical_codes(lengths):
    """The canonical codes of ``lengths``, bit-reversed for an LSB-first
    writer (VP8L reads a code's first bit from the stream's next bit)."""
    import numpy as np

    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(lengths.size, np.int64)
    code = 0
    for n in range(1, int(lengths.max()) + 1):
        for s in np.flatnonzero(lengths == n):
            codes[s] = int(format(code, f"0{n}b")[::-1], 2)
            code += 1
        code <<= 1
    return codes


def vp8l_bytes(px):
    """Pixels [H, W, 3] uint8 as a lossless WebP (a simple-format VP8L
    file): the subtract-green transform, then canonical prefix codes from
    the green, red and blue histograms (their lengths through a
    code-length code without repeat codes), alpha and distance as
    one-symbol codes, no colour cache, every pixel a literal."""
    import struct

    import numpy as np

    h, w, _ = px.shape
    g = px[..., 1].reshape(-1).astype(np.int64)
    chans = [g, (px[..., 0].reshape(-1).astype(np.int64) - g) & 255,
             (px[..., 2].reshape(-1).astype(np.int64) - g) & 255]
    head = []  # (value, bits) of the header, LSB first

    def put(v, n):
        head.append((int(v), n))

    put(0x2F, 8)
    put(w - 1, 14)
    put(h - 1, 14)
    put(0, 1)  # no alpha
    put(0, 3)  # version
    put(1, 1)  # a transform:
    put(2, 2)  # subtract green
    put(0, 1)  # no more transforms
    put(0, 1)  # no colour cache
    put(0, 1)  # no meta prefix codes
    tables = []
    for alphabet, sym in ((280, chans[0]), (256, chans[1]), (256, chans[2])):
        counts = np.bincount(sym, minlength=alphabet)
        used = np.flatnonzero(counts)
        if used.size == 1:  # a one-symbol code takes no bits
            put(1, 1)
            put(0, 1)
            put(1, 1)
            put(int(used[0]), 8)
            tables.append((np.zeros(alphabet, np.int64), np.zeros(alphabet, np.int64)))
            continue
        lengths = _huffman_lengths(counts, 15)
        cl_lengths = _huffman_lengths(np.bincount(lengths, minlength=19), 7)
        cl_codes = _canonical_codes(cl_lengths)
        put(0, 1)  # a normal code
        put(19 - 4, 4)
        for s in (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15):
            put(cl_lengths[s], 3)
        put(0, 1)  # lengths for the whole alphabet
        for n in lengths:
            put(cl_codes[n], int(cl_lengths[n]))
        tables.append((_canonical_codes(lengths), lengths))
    for sym in (255, 0):  # alpha 255, distance code 0: one-symbol codes
        put(1, 1)
        put(0, 1)
        put(1, 1)
        put(sym, 8)
    value = np.zeros(g.size, np.uint64)
    nbits = np.zeros(g.size, np.int64)
    for (codes, lengths), sym in zip(tables, chans):
        value |= codes[sym].astype(np.uint64) << nbits.astype(np.uint64)
        nbits += lengths[sym]
    head_bits = np.array([(v >> k) & 1 for v, n in head for k in range(n)], np.uint8)
    parts = [head_bits]
    shifts = np.arange(45, dtype=np.uint64)
    for i in range(0, g.size, 1 << 16):  # pixels' bits, in slices to bound memory
        v, n = value[i:i + (1 << 16)], nbits[i:i + (1 << 16)]
        bits = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
        parts.append(bits[np.arange(45) < n[:, None]])
    payload = np.packbits(np.concatenate(parts), bitorder="little").tobytes()
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def config3_cli_runs(card, traversal, cli_render, files, names, held, max_ulp=0):
    """The config-3 CLI (phase 24's scene at ``ENVTEX_FULL``, written anew)
    with ``map_Kd`` on each of ``names`` in turn, ``files`` (name -> bytes)
    written beside phase 24's albedo.png first: exit 0 and 6 tree closest
    launches a run, each frame lit, and for each run in ``held`` one launch
    held to the plain walk within ``max_ulp``; returns the frames by name,
    the wall and parse times, and the tree kernel's errors."""
    import numpy as np
    import torch

    from akari_torch.integrators import path as path_mod
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.scene.builtin import write_envtex_terrain

    full = ENVTEX_FULL
    cfg_spp, depth = full["spp"], full["depth"]
    chunk = max(1, min(cfg_spp, path_mod.MAX_RAYS_IN_FLIGHT // full["res"] ** 2))
    expect = {"tree_intersect.closest": -(-cfg_spp // chunk) * (1 + depth)}
    frames, out, errs = {}, {}, [0.0, 0.0]
    with tempfile.TemporaryDirectory() as tmp:
        akari = write_envtex_terrain(tmp, **full)
        for name, data in files.items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
        mtl = os.path.join(tmp, "terrain.mtl")
        with open(mtl) as f:
            mtl_text = f.read()
        for run, albedo_name in enumerate(names):
            with open(mtl, "w") as f:
                f.write(mtl_text.replace("map_Kd albedo.png", f"map_Kd {albedo_name}"))
            reset_all(traversal)
            with log_records() as logbuf, captured_write_png() as written, \
                    kept_call(ti, ["closest"], keep=1) as calls:
                t0 = time.perf_counter()
                rc = cli_render.main(["-i", akari, "-o", os.path.join(tmp, f"cli{run}.png"),
                                      "--device", "cuda", "-v"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got = {f"{m.__name__.split('.')[-1]}.{n}": c for m in traversal
                   for n, c in m.LAUNCHES.items() if c}
            check(rc == 0, f"CLI on {albedo_name} returned {rc}")
            check(got == expect, f"CLI on {albedo_name}: launches {got}, expected {expect}")
            if albedo_name in held:  # one launch of the path against the plain walk
                rays_k, args_k = calls.kept["closest"]
                err = compare_kernel(f"tree config-3 {albedo_name} launch", rays_k, ti, args_k,
                                     2 * (full["n"] - 1) ** 2 + 2, max_ulp_allowed=max_ulp)
                errs = [max(errs[0], err[0]), max(errs[1], err[1])]
            del calls
            frames[albedo_name] = np.asarray(written[-1])
            check_image(frames[albedo_name], full["res"], f"CLI on {albedo_name}")
            parse_s = parsed_seconds(logbuf.getvalue())
            log(f"  CLI with map_Kd {albedo_name}: time to first image {wall:.3f} s wall (parse "
                f"OBJ + MTL + texture + sky {parse_s:.3f} s), launches {got} [card: {card}]")
            out[f"cli_{albedo_name}_s"], out[f"parse_{albedo_name}_s"] = wall, parse_s
    return frames, out, errs


def format_phase(card, traversal, cli_render):
    """Phase 42: the TGA, BMP, PNM, GIF and PSD decoders on this machine
    (no PIL here): the fixtures' digests, the 2048^2 albedo decoded from
    each format beside phase 41's PNG median, and the config-3 CLI with a
    TGA-RLE and a BMP albedo (their frames bit-equal; main holds them to
    phase 51's PNG-route frame of the same pixels); returns the figures it
    logs and the frame."""
    import hashlib

    import numpy as np

    from akari_torch.core.image import decode_image

    t_phase = time.perf_counter()
    log(f"phase 42: TGA, BMP, PNM, GIF and PSD decoding without PIL: the fixtures' digests, "
        f"the 2048^2 albedo in each format, the config-3 CLI on TGA-RLE and BMP albedos "
        f"[card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items()
                   if k.endswith((".tga", ".bmp", ".pbm", ".pgm", ".ppm", ".gif", ".psd"))}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    files, gif_px = albedo_files(albedo)
    png_s, png_runs = png_decode_median()  # phase 41's (its JPEG median is phase 41's too)
    out = {"png_decode_s": png_s}
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"(runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for key in ("tga", "tga_rle", "bmp", "ppm", "gif", "psd"):
        px = decode_image(files[key], key)
        if key == "gif":
            check(np.array_equal(px, gif_px), "the 2048^2 GIF decodes to other pixels")
        else:
            check(np.array_equal(px, albedo), f"the 2048^2 {key} decodes to other pixels")
        med, runs = _median_s(lambda: decode_image(files[key], key))
        out[f"{key}_decode_s"] = med
        log(f"  2048^2 {key} decode on the host, median of 3: {med:.4f} s ({len(files[key])} "
            f"bytes; runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
    for key in ("tga", "tga_rle", "bmp", "ppm"):
        check(out[f"{key}_decode_s"] <= out["png_decode_s"],
              f"{key} decodes the albedo slower than the PNG route: {out[f'{key}_decode_s']:.4f} "
              f"s against {out['png_decode_s']:.4f} s")

    # the PNG route of these pixels runs in phase 51 (its png_frame): main
    # holds these frames to it
    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render, {"albedo.tga": files["tga_rle"], "albedo.bmp": files["bmp"]},
        ("albedo.tga", "albedo.bmp"), set())
    out.update(cli)
    check(np.array_equal(frames["albedo.tga"], frames["albedo.bmp"]),
          "the frames on the TGA-RLE and the BMP albedo differ")
    log("  the TGA-RLE and BMP albedo frames are bit-equal (phase 51 holds them to the PNG "
        "route's)")
    out["frame"] = frames["albedo.tga"]
    log(f"  phase 42: {time.perf_counter() - t_phase:.1f} s")
    return out


def tiff_albedo_files(px, mapper=map):
    """The config-3 albedo's pixels [H, W, 3] uint8 as TIFFs written by
    ``tools/make_torch_port_image_fixtures.py``'s ``tiff_bytes`` (64-row
    strips unless tiled; ``mapper`` spreads the compression over
    processes): raw, PackBits, LZW, LZW with the horizontal predictor
    (Photoshop's "LZW"), LZW in 256^2 tiles, Deflate in planes, and 16-bit
    Deflate with the predictor of samples v * 257 (whose high bytes are the
    pixels); the file bytes by name."""
    import numpy as np

    from tools.make_torch_port_image_fixtures import tiff_bytes

    wide = px.astype(np.int64) * 257
    forms = {
        "raw": (px, 8, dict()),
        "packbits": (px, 8, dict(compression=32773)),
        "lzw": (px, 8, dict(compression=5)),
        "lzw_pred2": (px, 8, dict(compression=5, predictor=2)),
        "lzw_tiled": (px, 8, dict(compression=5, tile=(256, 256))),
        "deflate_planar": (px, 8, dict(compression=8, planar=2)),
        "rgb16_deflate_pred2": (wide, 16, dict(compression=8, predictor=2)),
    }
    out = {}
    for key, (samples, bits, kw) in forms.items():
        if "tile" not in kw:
            kw["rows_per_strip"] = 64
        out[key] = tiff_bytes(samples, bits, 2, mapper=mapper, **kw)
    return out


def tiff_phase(card, traversal, cli_render):
    """Phase 43: the TIFF decoder and the 4-component JPEGs on this machine
    (no PIL here): the fixtures' digests, the 2048^2 albedo decoded from
    seven TIFF forms against the PNG route's time, the config-3 CLI on the
    8-bit LZW-with-predictor and the 16-bit Deflate TIFFs (bit-equal frames,
    6 tree closest launches each; main holds them to phase 51's PNG-route
    frame of the same pixels), and
    ``--sharded --ao`` against the
    unsharded CLI; returns the tree kernel's errors and the figures it
    logs."""
    import hashlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from akari_torch.core.image import decode_image

    t_phase = time.perf_counter()
    log(f"phase 43: TIFF and CMYK / YCCK JPEG decoding without PIL: the fixtures' digests, "
        f"the 2048^2 albedo as seven TIFFs, the config-3 CLI on two TIFF albedos, --sharded "
        f"--ao [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items()
                   if k.endswith(".tif") or k.startswith(("cmyk", "ycck"))}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 17, f"only {len(digests)} TIFF / CMYK fixtures in digests.json")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        files = tiff_albedo_files(albedo, pool.map)
    log(f"  wrote the seven 2048^2 TIFFs in {time.perf_counter() - t0:.1f} s ({workers} "
        "processes, LZW in Python)")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 png decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for key, data in files.items():
        px = decode_image(data, key)
        check(np.array_equal(px, albedo), f"the 2048^2 TIFF {key} decodes to other pixels")
        med, runs = _median_s(lambda: decode_image(data, key))
        out[f"tiff_{key}_decode_s"] = med
        log(f"  2048^2 TIFF {key} decode on the host, median of 3: {med:.4f} s ({len(data)} "
            f"bytes; runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
        check(med <= png_s, f"TIFF {key} decodes the albedo slower than the PNG route: "
              f"{med:.4f} s against {png_s:.4f} s")

    # the PNG route of these pixels runs in phase 51 (its png_frame): main
    # holds these frames to it
    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_lzw.tif": files["lzw_pred2"], "albedo_16.tif": files["rgb16_deflate_pred2"]},
        ("albedo_lzw.tif", "albedo_16.tif"), set())
    out.update(cli)
    check(np.array_equal(frames["albedo_lzw.tif"], frames["albedo_16.tif"]),
          "the frames on the 8-bit LZW and the 16-bit Deflate TIFF albedo differ")
    log("  the 8-bit LZW and 16-bit Deflate TIFF albedo frames are bit-equal (phase 51 holds "
        "them to the PNG route's)")
    out["frame"] = frames["albedo_lzw.tif"]

    # --sharded with --ao renders unsharded, as the reference does
    with tempfile.TemporaryDirectory() as tmp:
        args = ["-i", SCENE_FILE, "--device", "cuda", "--width", "64", "--height", "64",
                "--spp", "4", "--ao"]
        paths = [os.path.join(tmp, n) for n in ("sharded.png", "plain.png")]
        rcs = [cli_render.main(args + ["-o", paths[0], "--sharded"]),
               cli_render.main(args + ["-o", paths[1]])]
        with open(paths[0], "rb") as fa, open(paths[1], "rb") as fb:
            same = fa.read() == fb.read()
    check(rcs == [0, 0], f"--sharded --ao returned {rcs[0]} (unsharded {rcs[1]})")
    check(same, "--sharded --ao wrote another image than the unsharded --ao")
    log("  --sharded --ao: exit 0, its PNG bit-equal to the unsharded CLI's")
    log(f"  phase 43: {time.perf_counter() - t_phase:.1f} s")
    return out


def webp_phase(card, traversal, cli_render):
    """Phase 44: the WebP decoder on this machine (no PIL here): the WebP
    fixtures' digests, the 2048^2 albedo as the committed lossy WebP and as
    a lossless one written here (``vp8l_bytes``), each decode's median of 3
    no slower than the PNG route's, and the config-3 CLI on both (6 tree
    closest launches each; main holds the lossless one's frame to phase
    51's PNG-route frame of the same pixels; the lossy one's PNG route is
    held on the CPU, ``tests/test_torch_image_webp.py::
    test_obj_map_kd_webp_renders_equal_to_the_png_route``); returns the
    figures it logs and that frame."""
    import hashlib

    import numpy as np

    from akari_torch.core.image import decode_image

    t_phase = time.perf_counter()
    log(f"phase 44: WebP decoding without PIL: the fixtures' digests, the 2048^2 albedo as "
        f"lossy and lossless WebP, the config-3 CLI on both [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items() if k.endswith(".webp")}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 14, f"only {len(digests)} WebP fixtures in digests.json")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    with open(os.path.join(IMAGE_FIXTURES, ALBEDO_WEBP), "rb") as f:
        lossy = f.read()
    t0 = time.perf_counter()
    lossless = vp8l_bytes(albedo)
    log(f"  wrote the 2048^2 lossless WebP in {time.perf_counter() - t0:.2f} s ({len(lossless)} "
        "bytes: subtract-green, prefix codes from the histograms)")
    check(np.array_equal(decode_image(lossless, "lossless"), albedo),
          "the lossless 2048^2 WebP decodes to other pixels than it was written from")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 png decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for key, data in (("lossy", lossy), ("lossless", lossless)):
        med, runs = _median_s(lambda: decode_image(data, key))
        out[f"webp_{key}_decode_s"] = med
        log(f"  2048^2 {key} WebP decode on the host, median of 3: {med:.4f} s ({len(data)} "
            f"bytes; runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
        check(med <= png_s, f"the {key} WebP decodes the albedo slower than the PNG route: "
              f"{med:.4f} s against {png_s:.4f} s")

    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_q85.webp": lossy, "albedo_lossless.webp": lossless},
        ("albedo_q85.webp", "albedo_lossless.webp"), set())
    out.update(cli)
    log("  phase 51 holds the lossless WebP albedo's frame to the PNG route's")
    out["frame"] = frames["albedo_lossless.webp"]
    log(f"  phase 44: {time.perf_counter() - t_phase:.1f} s")
    return out


def dds_phase(card, traversal, cli_render):
    """Phase 45: the DDS, BLP and FTEX decoders on this machine (no PIL
    here): their fixtures' digests; the 2048^2 albedo written by
    ``tools/dds_writers.py`` as BC1 (FourCC DXT1) and as BC7 (DX10,
    BC7_UNORM_SRGB), each with its full mip chain, each decode's median of
    3 no slower than the PNG route's; and the config-3 CLI on each DDS (6
    tree closest launches each; the PNG route of a DDS's pixels is held on
    the CPU, ``tests/test_torch_image_dds.py::
    test_obj_map_kd_dds_renders_equal_to_the_png_route``); returns the
    figures it logs."""
    import hashlib

    import numpy as np

    from akari_torch.core.image import decode_image
    from tools.dds_writers import dds_albedo

    t_phase = time.perf_counter()
    log(f"phase 45: DDS, BLP and FTEX decoding without PIL: the fixtures' digests, the 2048^2 "
        f"albedo as BC1 and BC7 DDS, the config-3 CLI on both [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items()
                   if k.endswith((".dds", ".blp", ".ftc", ".ftu"))}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 32, f"only {len(digests)} DDS / BLP / FTEX fixtures in digests.json")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    files, decoded, out = {}, {}, {}
    for form in ("BC1", "BC7"):
        t0 = time.perf_counter()
        files[form] = dds_albedo(albedo, form)
        decoded[form] = decode_image(files[form], form)
        check(decoded[form].shape == albedo.shape, f"the {form} DDS decodes to "
              f"{decoded[form].shape}")
        err = np.abs(decoded[form].astype(np.int32) - albedo).mean()
        out[f"{form}_mean_abs_err"] = float(err)
        log(f"  wrote the 2048^2 {form} DDS with its mip chain in {time.perf_counter() - t0:.2f} s "
            f"({len(files[form])} bytes; mean |decoded - albedo| {err:.3f} levels)")
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 png decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for form, data in files.items():
        med, runs = _median_s(lambda: decode_image(data, form))
        out[f"dds_{form}_decode_s"] = med
        log(f"  2048^2 {form} DDS decode on the host, median of 3: {med:.4f} s ({len(data)} "
            f"bytes; runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
        check(med <= png_s, f"the {form} DDS decodes the albedo slower than the PNG route: "
              f"{med:.4f} s against {png_s:.4f} s")

    _, cli, _ = config3_cli_runs(
        card, traversal, cli_render, {f"albedo_{form}.dds": data for form, data in files.items()},
        ("albedo_BC1.dds", "albedo_BC7.dds"), set())
    out.update(cli)
    log(f"  phase 45: {time.perf_counter() - t_phase:.1f} s")
    return out


LEGACY_SUFFIXES = (".ico", ".cur", ".qoi", ".sgi", ".rgba", ".bw", ".pcx", ".tiff")


def legacy_phase(card, traversal, cli_render):
    """Phase 46: the ICO / CUR, QOI, SGI and PCX decoders and the LZMA /
    ZSTD TIFF strips on this machine (no PIL here): their fixtures' digests;
    the 2048^2 albedo written here by ``tools/legacy_writers.py`` as QOI,
    RLE SGI and 24-bit RLE PCX and by ``tiff_bytes`` as an LZMA TIFF with
    the horizontal predictor, and the committed 2048^2 ZSTD TIFF, each
    decode's median of 3 beside the PNG route's (no slower for all but
    LZMA, which is recorded); and the config-3 CLI on the RLE SGI and the
    PCX albedos (frames bit-equal, 6 tree closest launches each; main holds
    them to phase 51's PNG-route frame of the same pixels); returns the
    figures it logs and the frame."""
    import hashlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from akari_torch.core.image import decode_image
    from akari_torch.scene.builtin import envtex_texture
    from tools.legacy_writers import pcx_bytes, qoi_bytes, sgi_bytes
    from tools.make_torch_port_image_fixtures import ZSTD_ALBEDO, tiff_bytes

    t_phase = time.perf_counter()
    log(f"phase 46: ICO / CUR, QOI, SGI, PCX and LZMA / ZSTD TIFF decoding without PIL: the "
        f"fixtures' digests, the 2048^2 albedo in five forms, the config-3 CLI on an SGI and a "
        f"PCX albedo [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items()
                   if k.endswith(LEGACY_SUFFIXES) or "zstd" in k or "lzma" in k}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 22, f"only {len(digests)} ICO / CUR / QOI / SGI / PCX / LZMA / ZSTD "
          "fixtures in digests.json")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    workers = max(1, min(8, os.cpu_count() or 1))
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    writers = {
        "QOI": lambda: qoi_bytes(albedo, index=False),
        "RLE SGI": lambda: sgi_bytes(albedo.transpose(2, 0, 1), 1, True),
        "24-bit PCX": lambda: pcx_bytes(albedo, 8, 3),
        # 64-row strips compressed over the processes, as phase 43's
        "LZMA TIFF": lambda: tiff_bytes(albedo, 8, 2, compression=34925, predictor=2,
                                        rows_per_strip=64, mapper=pool.map),
    }
    files, out = {}, {}
    with pool:
        for form, write in writers.items():
            t0 = time.perf_counter()
            files[form] = write()
            log(f"  wrote the 2048^2 {form} in {time.perf_counter() - t0:.2f} s "
                f"({len(files[form])} bytes)")
    for form, data in files.items():
        check(np.array_equal(decode_image(data, form), albedo),
              f"the 2048^2 {form} decodes to other pixels than the albedo")
    with open(os.path.join(IMAGE_FIXTURES, ZSTD_ALBEDO), "rb") as f:
        files["ZSTD TIFF"] = f.read()
    x32 = np.repeat(np.repeat(envtex_texture(64, 0), 32, 0), 32, 1)
    check(np.array_equal(decode_image(files["ZSTD TIFF"], ZSTD_ALBEDO), x32),
          f"{ZSTD_ALBEDO} decodes to other pixels than the 64^2 albedo scaled up 32x")
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 png decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for form, data in files.items():
        med, runs = _median_s(lambda: decode_image(data, form))
        out[f"{form.replace(' ', '_')}_decode_s"] = med
        log(f"  2048^2 {form} decode on the host, median of 3: {med:.4f} s ({len(data)} bytes; "
            f"runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
        if form != "LZMA TIFF":  # Python's lzma: recorded, not held to the PNG route
            check(med <= png_s, f"the {form} decodes the albedo slower than the PNG route: "
                  f"{med:.4f} s against {png_s:.4f} s")

    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_rle.sgi": files["RLE SGI"], "albedo_rle.pcx": files["24-bit PCX"]},
        ("albedo_rle.sgi", "albedo_rle.pcx"), set())
    out.update(cli)
    check(np.array_equal(frames["albedo_rle.sgi"], frames["albedo_rle.pcx"]),
          "the frames on the RLE SGI and the 24-bit PCX albedo differ")
    log("  the RLE SGI and 24-bit PCX albedo frames are bit-equal (phase 51 holds them to the "
        "PNG route's)")
    out["frame"] = frames["albedo_rle.sgi"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 46: {out['phase_s']:.1f} s")
    return out


JPEG_FORM_FIXTURES = ("arith_", "lossless_")  # with the files cut after a scan ("_cut")


def jpeg_forms_phase(card, traversal, cli_render):
    """Phase 47: the JPEG forms beyond baseline and progressive Huffman on
    this machine (no PIL here): the arithmetic-coded, lossless and cut
    progressive fixtures' digests; the 2048^2 albedo as an arithmetic-coded
    progressive JPEG (the committed baseline JPEG's coefficients re-coded
    here by ``tools/jpeg_writers.py``: its decode must equal the baseline's),
    as a lossless JPEG (predictor 1, written here: its decode must be the
    albedo) and as the committed progressive JPEG cut after its 6th scan
    (block smoothing), each decode's median of 3 beside the PNG route's and
    the baseline JPEG's; and the config-3 CLI on a PNG of the arithmetic
    file's pixels and on the arithmetic file (frames bit-equal, 6 tree
    closest launches each); returns the figures it logs."""
    import hashlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from akari_torch.core.image import decode_png, encode_png
    from akari_torch.core.jpeg import decode_jpeg
    from tools import jpeg_writers as jw
    from tools.make_torch_port_image_fixtures import ALBEDO_CUT

    t_phase = time.perf_counter()
    log(f"phase 47: arithmetic-coded, lossless and cut progressive JPEG decoding without PIL: "
        f"the fixtures' digests, the 2048^2 albedo in three forms, the config-3 CLI on an "
        f"arithmetic-coded albedo [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items()
                   if k.startswith(JPEG_FORM_FIXTURES) or "_cut" in k}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_jpeg(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 13, f"only {len(digests)} arithmetic / lossless / cut JPEG fixtures")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    with open(os.path.join(IMAGE_FIXTURES, ALBEDO_JPEG), "rb") as f:
        baseline = f.read()
    with open(os.path.join(IMAGE_FIXTURES, ALBEDO_CUT), "rb") as f:
        files = {"cut progressive JPEG": f.read()}
    base_px = decode_jpeg(baseline)
    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        files["arithmetic JPEG"] = jw.arith_jpeg(*jw.file_coefficients(baseline),
                                                 script=jw.PROGRESSION, mapper=pool.map)
    log(f"  wrote the 2048^2 arithmetic-coded progressive JPEG in {time.perf_counter() - t0:.2f} s "
        f"({workers} processes, {len(files['arithmetic JPEG'])} bytes)")
    t0 = time.perf_counter()
    files["lossless JPEG"] = jw.lossless_jpeg([albedo[..., i] for i in range(3)],
                                              [(1, 1, 1), (2, 1, 1), (3, 1, 1)], albedo.shape[:2], 1)
    log(f"  wrote the 2048^2 lossless JPEG (predictor 1) in {time.perf_counter() - t0:.2f} s "
        f"({len(files['lossless JPEG'])} bytes)")
    arith_px = decode_jpeg(files["arithmetic JPEG"])
    check(np.array_equal(arith_px, base_px),
          "the 2048^2 arithmetic-coded JPEG decodes to other pixels than its baseline twin")
    check(np.array_equal(decode_jpeg(files["lossless JPEG"]), albedo),
          "the 2048^2 lossless JPEG decodes to other pixels than the albedo")
    check(jw.scan_count(files["cut progressive JPEG"]) == 6,
          f"{ALBEDO_CUT} does not hold 6 scans")
    out = {}
    for form, data in (("PNG", png_data), ("baseline JPEG", baseline), *files.items()):
        med, runs = _median_s(lambda: decode_png(data) if form == "PNG" else decode_jpeg(data))
        out[f"{form.replace(' ', '_')}_decode_s"] = med
        log(f"  2048^2 {form} decode on the host, median of 3: {med:.4f} s ({len(data)} bytes; "
            f"runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")

    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_arith.png": encode_png(arith_px), "albedo_arith.jpg": files["arithmetic JPEG"]},
        ("albedo_arith.png", "albedo_arith.jpg"), set())
    out.update(cli)
    check(np.array_equal(frames["albedo_arith.jpg"], frames["albedo_arith.png"]),
          "the frame on the arithmetic-coded JPEG differs from the PNG route's of its pixels")
    log("  the arithmetic-coded albedo's frame is bit-equal to the PNG route's of its pixels")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 47: {out['phase_s']:.1f} s")
    return out


FAX_FIXTURES = ("tiff_pil_group", "tiff_pil_tiff_ccitt", "tiff_pil_tiff_raw_16", "tiff_mh_",
                "tiff_mr_", "tiff_mmr_", "tiff_rle", "tiff_thunder_", "tiff_ojpeg_")


def fax_albedo_files(px, mapper=map):
    """The config-3 albedo's pixels [H, W, 3] uint8 as the TIFFs of phase
    48, written by ``tools/tiff_writers.py`` (``mapper`` spreads the strips
    over processes): its luma (ITU-R 601, integer) below the median as a
    bilevel Group 4 TIFF (64-row strips, min-is-white: a set bit black);
    the luma's top four bits as a ThunderScan TIFF (64-row strips); and the
    committed ``ALBEDO_JPEG`` wrapped as an old-style JPEG TIFF in the
    interchange form (one strip); the file bytes by name."""
    import numpy as np

    from tools.make_torch_port_image_fixtures import tiff_bytes
    from tools.tiff_writers import fax_strips, ojpeg_tiff, thunder_strips

    wide = px.astype(np.int32)
    luma = (wide[..., 0] * 299 + wide[..., 1] * 587 + wide[..., 2] * 114) // 1000
    bits = (luma < np.median(luma)).astype(np.uint8)
    grey4 = (luma >> 4).astype(np.uint8)
    with open(os.path.join(IMAGE_FIXTURES, ALBEDO_JPEG), "rb") as f:
        jpeg = f.read()
    return {
        "group4": tiff_bytes(bits[..., None], 1, 0, compression=4, rows_per_strip=64,
                             blocks=fax_strips(bits, 4, 64, mapper)),
        "thunderscan": tiff_bytes(grey4[..., None], 4, 1, compression=32809, rows_per_strip=64,
                                  blocks=thunder_strips(grey4, 64, mapper)),
        "old-style JPEG": ojpeg_tiff(jpeg, "interchange"),
    }, bits, grey4


def fax_phase(card, traversal, cli_render):
    """Phase 48: the CCITT, ThunderScan and old-style JPEG TIFF decoders on
    this machine (no PIL here): the fixtures' digests; the 2048^2 albedo as
    a Group 4, a ThunderScan and an old-style JPEG TIFF (written here by
    ``tools/tiff_writers.py``; the first two must decode to the pixels
    written, the third to the committed JPEG's stream as libtiff's RGBA
    reader converts it), each decode's median of 3 beside the PNG route's;
    and the config-3 CLI on the Group 4 file and on the old-style JPEG (6
    tree closest launches each; the PNG route of a TIFF's pixels is held on
    the CPU, ``tests/test_torch_image_tiff.py::
    test_obj_map_kd_tiff_renders_equal_to_the_png_route``); returns the
    figures it logs."""
    import hashlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from akari_torch.core.image import decode_image

    t_phase = time.perf_counter()
    log(f"phase 48: CCITT, ThunderScan and old-style JPEG TIFF decoding without PIL: the "
        f"fixtures' digests, the 2048^2 albedo in three forms, the config-3 CLI on the Group 4 "
        f"and old-style JPEG albedos [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items() if k.startswith(FAX_FIXTURES)}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 16, f"only {len(digests)} CCITT / ThunderScan / OJPEG fixtures")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        files, bits, grey4 = fax_albedo_files(albedo, pool.map)
    log(f"  wrote the 2048^2 Group 4, ThunderScan and old-style JPEG TIFFs in "
        f"{time.perf_counter() - t0:.2f} s ({workers} processes; "
        + ", ".join(f"{k} {len(v)} bytes" for k, v in files.items()) + ")")
    decoded = {k: decode_image(v, k) for k, v in files.items()}
    check(np.array_equal(decoded["group4"][..., 0], np.where(bits == 1, 0, 255)),
          "the 2048^2 Group 4 TIFF decodes to other pixels than the bits written")
    check(np.array_equal(decoded["thunderscan"][..., 0], grey4 * np.uint8(17)),
          "the 2048^2 ThunderScan TIFF decodes to other pixels than the levels written")
    with open(os.path.join(IMAGE_FIXTURES, ALBEDO_JPEG), "rb") as f:
        bare = decode_image(f.read(), ALBEDO_JPEG)
    diff = np.abs(decoded["old-style JPEG"].astype(int) - bare).max(axis=-1)
    log(f"  the old-style JPEG TIFF against the bare JPEG's decode: {int(diff.max())} levels at "
        f"most, {float((diff > 0).mean()):.4f} of pixels differ (libtiff's RGBA reader repeats "
        "4:2:0 chroma where libjpeg interpolates it)")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for form, data in files.items():
        med, runs = _median_s(lambda: decode_image(data, form))
        out[f"{form.replace(' ', '_')}_decode_s"] = med
        log(f"  2048^2 {form} TIFF decode on the host, median of 3: {med:.4f} s ({len(data)} "
            f"bytes; runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")

    _, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_g4.tif": files["group4"], "albedo_oj.tif": files["old-style JPEG"]},
        ("albedo_g4.tif", "albedo_oj.tif"), set())
    out.update(cli)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 48: {out['phase_s']:.1f} s")
    return out


def jpeg2000_phase(card, traversal, cli_render):
    """Phase 49: the JPEG 2000 decoder on this machine (no PIL here): the
    J2K / JP2 fixtures' digests; the committed 2048^2 albedo as an
    irreversible JP2 and the 64^2 albedo scaled up 32x as a reversible J2K
    (which must decode to those pixels exactly), each decode's median of 3
    beside the PNG route's; and the config-3 CLI on a PNG of the JP2's
    pixels, on the JP2, on a PNG of the scaled-up albedo and on the J2K
    (frames bit-equal pairwise, 6 tree closest launches each); returns the
    figures it logs and the J2K's frame (phase 53's reference)."""
    import hashlib

    import numpy as np

    from akari_torch.core.image import decode_image, decode_png, encode_png
    from akari_torch.scene.builtin import envtex_texture
    from tools.make_torch_port_image_fixtures import ALBEDO_J2K, ALBEDO_JP2

    t_phase = time.perf_counter()
    log(f"phase 49: JPEG 2000 decoding without PIL: the fixtures' digests, the 2048^2 albedo as "
        f"an irreversible JP2 and a reversible J2K, the config-3 CLI on both [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items()
                   if k.startswith(("j2k_", "jp2_")) or k in (ALBEDO_JP2, ALBEDO_J2K)}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 33, f"only {len(digests)} JPEG 2000 fixtures in digests.json")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data = albedo_png()[0]  # phase 24's albedo.png
    files = {}
    for name in (ALBEDO_JP2, ALBEDO_J2K):
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            files[name] = f.read()
    jp2_px = decode_image(files[ALBEDO_JP2], ALBEDO_JP2)
    x32 = np.repeat(np.repeat(envtex_texture(64, 0), 32, 0), 32, 1)
    check(np.array_equal(decode_image(files[ALBEDO_J2K], ALBEDO_J2K), x32),
          f"{ALBEDO_J2K} decodes to other pixels than the 64^2 albedo scaled up 32x")
    diff = np.abs(jp2_px.astype(int) - decode_png(png_data)).max(axis=-1)
    log(f"  the 9/7 JP2 against the albedo: {int(diff.max())} levels at most, "
        f"{float((diff > 0).mean()):.4f} of pixels differ (lossy at a rate of 30)")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for name, data in files.items():
        med, runs = _median_s(lambda: decode_image(data, name))
        out[f"{name}_decode_s"] = med
        log(f"  2048^2 {name} decode on the host, median of 3: {med:.4f} s ({len(data)} bytes; "
            f"runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")

    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_jp2.png": encode_png(jp2_px), "albedo.jp2": files[ALBEDO_JP2],
         "albedo_x32.png": encode_png(x32), "albedo_x32.j2k": files[ALBEDO_J2K]},
        ("albedo_jp2.png", "albedo.jp2", "albedo_x32.png", "albedo_x32.j2k"), set())
    out.update(cli)
    for png, j2k in (("albedo_jp2.png", "albedo.jp2"), ("albedo_x32.png", "albedo_x32.j2k")):
        check(np.array_equal(frames[j2k], frames[png]),
              f"the frame on {j2k} differs from the PNG route's of its pixels")
    log("  the JP2 and J2K albedos' frames are bit-equal to the PNG route's of their pixels")
    out["x32_frame"] = frames["albedo_x32.j2k"]  # phase 53's reference
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 49: {out['phase_s']:.1f} s")
    return out


def start_htj2k_albedo():
    """Write ``ALBEDO_HTJ2K`` (the 64^2 albedo scaled up 32x as a reversible
    HT codestream, by the HT writer of ``tools/j2k_writers.py``; too large
    for the committed fixtures) in a process of its own while the phases
    before 53 run; the process is killed at exit if it still runs.
    Returns (process, path, start time)."""
    import atexit
    import shutil

    tmp = tempfile.mkdtemp(prefix="akari_htj2k_")
    path = os.path.join(tmp, "albedo_x32.j2c")
    code = ("import sys\n"
            "from tools.make_torch_port_image_fixtures import htj2k_albedo\n"
            "data = htj2k_albedo()\n"
            "with open(sys.argv[1], 'wb') as f:\n"
            "    f.write(data)\n")
    proc = subprocess.Popen([sys.executable, "-c", code, path], cwd=ROOT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return proc, path, time.perf_counter()


def htj2k_phase(card, traversal, cli_render, writer, j2k_frame, j2k_decode_s):
    """Phase 53: HTJ2K (Part 15) and the Part-2 MCT / MCC / MCO / CBD
    markers on this machine (no PIL here): the ``htj2k_*`` and ``part2_*``
    fixtures' digests; ``ALBEDO_HTJ2K`` from ``start_htj2k_albedo``, which
    must decode to the 64^2 albedo scaled up 32x exactly, its decode's
    median of 3 beside phase 41's PNG median and phase 49's J2K median (the
    same pixels through the MQ coder); and one config-3 CLI run on it (6
    tree closest launches), its frame bit-equal to phase 49's on the J2K
    (no launch held: phase 49's run saw the same rays); returns the
    figures it logs."""
    import hashlib

    import numpy as np

    from akari_torch.core.image import decode_image
    from akari_torch.scene.builtin import envtex_texture

    t_phase = time.perf_counter()
    log(f"phase 53: HTJ2K and Part-2 JPEG 2000 without PIL: the fixtures' digests, the 2048^2 "
        f"albedo as an HT codestream, the config-3 CLI on it [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items() if k.startswith(("htj2k_", "part2_"))}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 12, f"only {len(digests)} HTJ2K / Part-2 fixtures in digests.json")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    proc, path, t_start = writer
    t0 = time.perf_counter()
    rc = proc.wait(timeout=600)
    waited = time.perf_counter() - t0
    check(rc == 0, f"writing the HT albedo failed ({rc})")
    with open(path, "rb") as f:
        data = f.read()
    log(f"  the HT albedo, written in a process of its own since phase 1 ({len(data)} bytes, "
        f"{t0 + waited - t_start:.1f} s after its start; waited {waited:.2f} s here)")
    x32 = np.repeat(np.repeat(envtex_texture(64, 0), 32, 0), 32, 1)
    check(np.array_equal(decode_image(data, "albedo_x32.j2c"), x32),
          "the HT albedo decodes to other pixels than the 64^2 albedo scaled up 32x")
    log("  the HT albedo decodes to the 64^2 albedo scaled up 32x exactly (lossless)")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"(runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    log(f"  2048^2 reversible J2K decode on the host, median of 3 (phase 49's): "
        f"{j2k_decode_s:.4f} s [card: {card}]")
    med, runs = _median_s(lambda: decode_image(data, "albedo_x32.j2c"))
    out["htj2k_decode_s"] = med
    log(f"  2048^2 HTJ2K decode on the host, median of 3: {med:.4f} s ({len(data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
    frames, cli, _ = config3_cli_runs(card, traversal, cli_render, {"albedo_x32.j2c": data},
                                      ("albedo_x32.j2c",), set())
    out.update(cli)
    check(np.array_equal(frames["albedo_x32.j2c"], j2k_frame),
          "the frame on the HT albedo differs from phase 49's on the J2K of the same pixels")
    log("  the HT albedo's frame is bit-equal to phase 49's on the J2K of the same pixels")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 53: {out['phase_s']:.1f} s")
    return out


AVIF_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_avif")
ALBEDO_AVIF = "albedo2048_q60.avif"   # envtex_texture(2048, 0), quality 60, speed 6, 4:2:0
# the same at speed 4 with CDEF, quantizer matrices, film grain and loop restoration
ALBEDO_AVIF_TOOLS = "albedo2048_q60_s4_tools.avif"
# frame 0 of a two-frame avis sequence (the albedo, then its vertical flip) at
# speed 6 with aq-mode=1: a segmented frame
ALBEDO_AVIF_AQ = "albedo2048_q60_s6_aq1.avis.avif"
# slice 26: the albedo's frame 0 decoded through an inter frame (the splice
# of a two-frame sequence whose frame 1 is the albedo moved by (3, 5) and
# half a pixel), made here from the committed sequence
ALBEDO_AVIF_INTER_FRAME0 = "albedo2048_q60_s6_inter_frame0.avif"


def avif_phase(card, traversal, cli_render):
    """Phase 54: AVIF on this machine (no PIL, no AV1 encoder here): the
    fixtures of ``tests/data/torch_port_avif`` (format, PIL's mode and
    SHA-256 in their ``digests.json``: the tools of every writer speed and
    option, sequences and a grid among them); the committed 2048^2 albedo
    at quality 60, speed 6 (128x128 superblocks, 4 x 2 tiles), at speed 4
    with CDEF, quantizer matrices, film grain and loop restoration, and as
    frame 0 of a two-frame ``aq-mode=1`` sequence (segmented), each
    decode's median of 3 beside phase 41's PNG median; the forms of slice
    25, made here from the committed albedos by header rewrites
    (``tools/av1_rewrite.py``): the tools albedo at 10 and 12 bits and the
    speed-6 albedo at superres denominator 12 (3,072 wide), each file and
    decode held to the record of PIL's read (``AVIF_REWRITES``), each
    decode's median of 3; slice 26: the albedo's frame 0 spliced into an
    inter frame (``tools/av1_rewrite.py``'s ``splice_frames``), held to
    ``AVIF_REWRITES``, its decode's median of 3; and the config-3 CLI
    on a PNG of that inter frame 0's decoded pixels and on that AVIF (frames
    bit-equal, 6 tree closest launches each); returns the figures it logs."""
    import hashlib

    import numpy as np

    from akari_torch.core.avif import avif_frame_info, avif_planes
    from akari_torch.core.image import decode_with_mode, encode_png
    from tools.make_torch_port_image_fixtures import AVIF_REWRITES, avif_rewrite_albedo_files

    t_phase = time.perf_counter()
    log(f"phase 54: AVIF decoding without PIL: the fixtures' digests, the 2048^2 albedos as "
        f"AVIF (speed 6; speed 4 with CDEF, quantizer matrices, film grain, loop restoration; "
        f"a segmented aq-mode=1 sequence; the tools albedo at 10 and 12 bits, superres 12/8; "
        f"frame 0 through an inter frame), the config-3 CLI on the inter-frame albedo "
        f"[card: {card}]")
    with open(os.path.join(AVIF_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    albedo, first_s = {}, {}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(AVIF_FIXTURES, fname), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        fmt, mode, px, _ = decode_with_mode(data, fname)
        decode_s = time.perf_counter() - t0
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(fmt == "AVIF" and mode == rec["mode"] and list(px.shape) == rec["shape"]
              and digest == rec["sha256"],
              f"{fname}: read as {fmt} {mode} {px.shape}, sha256 {digest[:16]}..., PIL's "
              f"{rec['mode']} {rec['sha256'][:16]}...")
        if fname in (ALBEDO_AVIF, ALBEDO_AVIF_TOOLS, ALBEDO_AVIF_AQ):
            albedo[fname], first_s[fname] = (data, px), decode_s
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 36 and len(albedo) == 3,
          f"{len(digests)} AVIF fixtures, the albedos {sorted(albedo)} in them")
    log(f"  {len(digests)} fixtures decoded (RGB and RGBA, 4:2:0 / 4:2:2 / 4:4:4 / grey, tiles, "
        f"palettes, lossless, CDEF, quantizer matrices, film grain, Wiener and self-guided "
        f"restoration, delta q / lf, intra block copy, segmentation, sequences, a 3 x 2 grid); "
        f"every SHA-256 and mode equals PIL {', '.join(pil)}'s in digests.json")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"(runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for fname, key in ((ALBEDO_AVIF, "avif_decode_s"), (ALBEDO_AVIF_TOOLS, "avif_tools_decode_s"),
                       (ALBEDO_AVIF_AQ, "avif_aq_decode_s")):
        data = albedo[fname][0]
        info = avif_frame_info(data)
        log(f"  {fname}: {len(data)} bytes, {info['width']} x {info['height']}, "
            f"{128 if info['sb128'] else 64}^2 superblocks, {info['tile_cols']} x "
            f"{info['tile_rows']} tiles, base_q_idx {info['base_q_idx']}, quantizer-matrix "
            f"levels 0x{info['qm_levels']:03x} (fff: none), {info['cdef_strengths']} nonzero CDEF "
            f"strengths, restoration types 0b{info['lr_types']:06b} (v u y), film grain "
            f"{info['film_grain']}, segmentation {info['segmentation']}, delta q "
            f"{info['delta_q']}, intra block copy {info['intrabc']}")
        # the digest's decode is the first of the three runs
        runs = [first_s[fname]] + _median_s(lambda: decode_with_mode(data, fname), 2)[1]
        med = sorted(runs)[1]
        out[key] = med
        log(f"  2048^2 AVIF decode on the host ({fname}), median of 3: {med:.4f} s (runs "
            f"{', '.join(f'{t:.4f}' for t in runs)}; {med / png_s:.2f}x the PNG's) [card: {card}]")
    tools_data = albedo[ALBEDO_AVIF_TOOLS][0]
    filters = {}
    avif_planes(tools_data, ALBEDO_AVIF_TOOLS, filters=filters)
    info = avif_frame_info(tools_data)
    check(info["qm_levels"] != 0xFFF and info["cdef_strengths"] and info["lr_types"] & 3 == 3
          and info["film_grain"] and filters["cdef_blocks"] and filters["lr_stripes"]
          and filters["grain_planes"] == 3,
          f"the tools albedo does not run every tool: {info}, {filters}")
    log(f"  the tools albedo's filters: {filters['cdef_blocks']} 8x8 blocks CDEF-filtered, "
        f"{filters['lr_stripes']} restoration unit stripes, grain on {filters['grain_planes']} "
        f"planes")
    aq_data = albedo[ALBEDO_AVIF_AQ][0]
    stats = {}
    avif_planes(aq_data, ALBEDO_AVIF_AQ, stats)
    info = avif_frame_info(aq_data)
    check(info["segmentation"] and stats["segmented_blocks"] > 0,
          f"the aq-mode albedo's frame 0 is not segmented: {info}, {stats}")
    log(f"  the aq-mode albedo's frame 0: {stats['segmented_blocks']} of {stats['blocks']} blocks "
        f"in a nonzero segment, {stats['delta_q_superblocks']} superblocks with a delta q, "
        f"{stats['intrabc_blocks']} intra block copies")
    # slice 25: header rewrites of the committed albedos, held to PIL's read
    with open(AVIF_REWRITES) as f:
        rec = json.load(f)
    t0 = time.perf_counter()
    rewrites = avif_rewrite_albedo_files(AVIF_FIXTURES)
    log(f"  the slice-25 and slice-26 albedos rewritten from the committed files in "
        f"{time.perf_counter() - t0:.3f} s (host clock)")
    check(sorted(rewrites) == sorted(rec), f"rewrites {sorted(rewrites)}, recorded {sorted(rec)}")
    inter_px = None
    for fname, key in (("albedo2048_q60_s4_tools_10bit.avif", "avif_tools10_decode_s"),
                       ("albedo2048_q60_s4_tools_12bit.avif", "avif_tools12_decode_s"),
                       ("albedo2048_q60_superres12.avif", "avif_superres12_decode_s"),
                       (ALBEDO_AVIF_INTER_FRAME0, "avif_inter_decode_s")):
        data, want = rewrites[fname], rec[fname]
        file_digest = hashlib.sha256(data).hexdigest()
        check(file_digest == want["file_sha256"],
              f"{fname}: rewritten as sha256 {file_digest[:16]}..., recorded "
              f"{want['file_sha256'][:16]}...")
        info = avif_frame_info(data)
        runs, px = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            fmt, mode, px, _ = decode_with_mode(data, fname)
            runs.append(time.perf_counter() - t0)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(fmt == "AVIF" and mode == "RGB" and list(px.shape) == want["shape"]
              and digest == want["sha256"],
              f"{fname}: read as {fmt} {mode} {px.shape}, sha256 {digest[:16]}..., PIL's "
              f"{want['sha256'][:16]}...")
        med = sorted(runs)[1]
        out[key] = med
        base = out["avif_tools_decode_s"] if "tools" in fname else out["avif_decode_s"]
        log(f"  {fname}: {len(data)} bytes, {info['width']} x {info['height']}, "
            f"{info['bit_depth']} bits, profile {info['profile']}, superres "
            f"{info['superres_denom']}/8; SHA-256 equals PIL {want['pil']}'s; decode on the host, "
            f"median of 3: {med:.4f} s (runs {', '.join(f'{t:.4f}' for t in runs)}; "
            f"{med / base:.2f}x its 8-bit source's) [card: {card}]")
        if fname == ALBEDO_AVIF_INTER_FRAME0:
            inter_data, inter_px = data, px
    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_avif.png": encode_png(inter_px), "albedo.avif": inter_data},
        ("albedo_avif.png", "albedo.avif"), set())
    out.update(cli)
    check(np.array_equal(frames["albedo.avif"], frames["albedo_avif.png"]),
          "the frame on the inter-frame AVIF albedo differs from the PNG route's of its pixels")
    log("  the inter-frame AVIF albedo's frame is bit-equal to the PNG route's of its pixels")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 54: {out['phase_s']:.1f} s")
    return out


LAB_FIXTURES = ("lab_", "tiff_lab_", "tiff_pil_lab_", "pfm_", "pnm_p", "dib_", "icns_")
LAB_CLI_TIFF = "albedo2048_lab_lzw.tif"


def lab_phase(card, traversal, cli_render):
    """Phase 50: the Lab (LittleCMS's Lab -> sRGB transform), PNM-mode, DIB
    and ICNS decoders on this machine (no PIL here): their fixtures'
    digests; the 2048^2 albedo written here with integer numpy as a raw
    and an LZW Lab TIFF, a PackBits Lab PSD, a ``Pf`` PFM and a 24-bit DIB,
    each file's SHA-256 and decode held to the record of PIL's read, each
    decode's median of 3 beside the PNG route's (the DIB and PFM no
    slower); and the config-3 CLI on a PNG of the LZW Lab TIFF's pixels and
    on that TIFF (frames bit-equal, 6 tree closest launches each); returns
    the figures it logs."""
    import hashlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from akari_torch.core.image import decode_image, encode_png
    from tools.make_torch_port_image_fixtures import GENERATED, lab_albedo_files

    t_phase = time.perf_counter()
    log(f"phase 50: Lab, PNM-mode, DIB and ICNS decoding without PIL: the fixtures' digests, "
        f"the 2048^2 albedo in five forms, the config-3 CLI on an LZW Lab TIFF albedo "
        f"[card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items() if k.startswith(LAB_FIXTURES)}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            px = decode_image(f.read(), fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 30, f"only {len(digests)} Lab / PNM / DIB / ICNS fixtures")
    log(f"  {len(digests)} fixtures decoded; every SHA-256 equals PIL {', '.join(pil)}'s in "
        "digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        files = lab_albedo_files(albedo, pool.map)
    log(f"  wrote the 2048^2 albedo in five forms in {time.perf_counter() - t0:.2f} s "
        f"({workers} processes; " + ", ".join(f"{k} {len(v)} bytes" for k, v in files.items())
        + ")")
    with open(GENERATED) as f:
        recorded = json.load(f)
    check(set(files) <= set(recorded), f"wrote {sorted(files)}, the record holds {sorted(recorded)}")
    decoded = {}
    for fname, data in files.items():
        rec = recorded[fname]
        file_sha = hashlib.sha256(data).hexdigest()
        check(file_sha == rec["file_sha256"],
              f"{fname}: written as sha256 {file_sha[:16]}..., recorded {rec['file_sha256'][:16]}...")
        px = decode_image(data, fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
        decoded[fname] = px
    log(f"  the five files equal the recorded bytes and decode to PIL "
        f"{', '.join(sorted({r['pil'] for r in recorded.values()}))}'s recorded reads")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for fname, data in files.items():
        med, runs = _median_s(lambda: decode_image(data, fname))
        out[f"{fname}_decode_s"] = med
        log(f"  2048^2 {fname} decode on the host, median of 3: {med:.4f} s ({len(data)} bytes; "
            f"runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
    for fname in ("albedo2048.pfm", "albedo2048_24.dib"):
        check(out[f"{fname}_decode_s"] <= png_s,
              f"{fname} decodes in {out[f'{fname}_decode_s']:.4f} s, slower than the PNG's "
              f"{png_s:.4f} s")

    frames, cli, _ = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_lab.png": encode_png(decoded[LAB_CLI_TIFF]), "albedo_lab.tif": files[LAB_CLI_TIFF]},
        ("albedo_lab.png", "albedo_lab.tif"), set())
    out.update(cli)
    check(np.array_equal(frames["albedo_lab.tif"], frames["albedo_lab.png"]),
          "the frame on the Lab TIFF differs from the PNG route's of its pixels")
    log("  the Lab TIFF albedo's frame is bit-equal to the PNG route's of its pixels")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 50: {out['phase_s']:.1f} s")
    return out


PLUGIN_FIXTURES = ("im_", "imt_", "iptc_", "spider_", "dcx_", "msp_", "xbm_")
PLUGIN_CLI_IM = "albedo2048_rgb.im"


def plugin_phase(card, traversal, cli_render):
    """Phase 51: the formats without a signature PIL tries on every file
    (IM, IMT, IPTC, PCD, SPIDER) and DCX, MSP and XBM, on this machine (no
    PIL here): their fixtures' digests; the 2048^2 albedo written here with
    integer numpy as an IM ``RGB image``, a DCX and a PhotoCD file, each
    file's SHA-256 and decode held to the record of PIL's read, each
    decode's median of 3 beside the PNG route's (the IM no slower); the
    config-3 CLI on a PNG of the IM file's pixels and on the IM file (frames
    bit-equal, 6 tree closest launches each, one launch of the IM run held
    to the plain walk at 0 ulp); returns the tree kernel's errors and the
    figures it logs."""
    import hashlib

    import numpy as np

    from akari_torch.core.image import decode_with_format, encode_png
    from tools.make_torch_port_image_fixtures import GENERATED, plugin_albedo_files

    t_phase = time.perf_counter()
    log(f"phase 51: IM, IMT, IPTC, PCD, SPIDER, DCX, MSP and XBM decoding without PIL: the "
        f"fixtures' digests, the 2048^2 albedo as IM, DCX and PhotoCD, the config-3 CLI on an "
        f"IM albedo [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items() if k.startswith(PLUGIN_FIXTURES)}
    formats = {}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            fmt, px = decode_with_format(f.read(), fname)
        formats[fmt] = formats.get(fmt, 0) + 1
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    pil = sorted({rec["pil"] for rec in digests.values()})
    check(len(digests) >= 45, f"only {len(digests)} IM / IMT / IPTC / SPIDER / DCX / MSP / XBM "
          "fixtures")
    log(f"  {len(digests)} fixtures decoded ({', '.join(f'{k} {v}' for k, v in formats.items())}); "
        f"every SHA-256 equals PIL {', '.join(pil)}'s in digests.json")

    png_data, albedo = albedo_png()  # phase 24's albedo.png, the PNG route's pixels
    t0 = time.perf_counter()
    files = plugin_albedo_files(albedo)
    log(f"  wrote the 2048^2 albedo in three forms in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {len(v)} bytes" for k, v in files.items()) + ")")
    with open(GENERATED) as f:
        recorded = json.load(f)
    check(set(files) <= set(recorded), f"wrote {sorted(files)}, the record holds {sorted(recorded)}")
    decoded = {}
    for fname, data in files.items():
        rec = recorded[fname]
        file_sha = hashlib.sha256(data).hexdigest()
        check(file_sha == rec["file_sha256"],
              f"{fname}: written as sha256 {file_sha[:16]}..., recorded {rec['file_sha256'][:16]}...")
        fmt, px = decode_with_format(data, fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
        check(fmt == fname.rsplit(".", 1)[1].upper(), f"{fname} read as {fmt}")
        decoded[fname] = px
    log(f"  the three files equal the recorded bytes and decode to PIL "
        f"{', '.join(sorted({recorded[k]['pil'] for k in files}))}'s recorded reads")
    out = {}
    png_s, png_runs = png_decode_median()  # phase 41's
    out["png_decode_s"] = png_s
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s "
        f"({len(png_data)} bytes; "
        f"runs {', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for fname, data in files.items():
        med, runs = _median_s(lambda: decode_with_format(data, fname))
        out[f"{fname}_decode_s"] = med
        log(f"  {fname} decode on the host, median of 3: {med:.4f} s ({len(data)} bytes; "
            f"runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
    check(out[f"{PLUGIN_CLI_IM}_decode_s"] <= png_s,
          f"{PLUGIN_CLI_IM} decodes in {out[f'{PLUGIN_CLI_IM}_decode_s']:.4f} s, slower than the "
          f"PNG's {png_s:.4f} s")

    frames, cli, (tree_err, tree_occ_err) = config3_cli_runs(
        card, traversal, cli_render,
        {"albedo_im.png": encode_png(decoded[PLUGIN_CLI_IM]), "albedo.im": files[PLUGIN_CLI_IM]},
        ("albedo_im.png", "albedo.im"), {"albedo.im"})
    out.update(cli)
    check(np.array_equal(frames["albedo.im"], frames["albedo_im.png"]),
          "the frame on the IM albedo differs from the PNG route's of its pixels")
    log("  the IM albedo's frame is bit-equal to the PNG route's of its pixels")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 51: {out['phase_s']:.1f} s")
    out["tree_err"], out["tree_occ_err"] = tree_err, tree_occ_err
    out["png_frame"] = frames["albedo_im.png"]   # the albedo's pixels: phase 52's reference
    return out


RASTER_FIXTURES = ("sun_", "flc_", "fli_", "fits_", "gbr_", "mcidas_", "pixar_", "xvthumb_",
                   "xpm_")
RASTER_CLI_SUN = "albedo2048_rle24.ras"


def raster_phase(card, traversal, cli_render, png_frame):
    """Phase 52: PIL's last plugins that load pixels (Sun raster, FLI /
    FLC, FITS, GBR, McIdas, PIXAR, XPM, XV thumbnail) on this machine (no
    PIL here): their fixtures' digests; the 2048^2 albedo written here with
    integer numpy as a 24-bit run-length Sun raster, an FLC whose frame 0 is
    BRUN-coded (RGB332) and a raw 8-bit FITS, each file's SHA-256 and decode
    held to the record of PIL's read, each decode's median of 3 beside phase
    41's PNG median (the Sun raster no slower); and one config-3 CLI run on
    the Sun raster (6 tree closest launches), its frame bit-equal to
    ``png_frame``, phase 51's frame of the same pixels through the PNG
    route. No launch of it is held to the plain walk: phase 51's held launch
    saw the same rays, dead rays and hits (the same texels give the same
    frame, launch for launch). Returns the figures it logs."""
    import hashlib

    import numpy as np

    from akari_torch.core.image import decode_with_format
    from tools.make_torch_port_image_fixtures import GENERATED, raster_albedo_files

    t_phase = time.perf_counter()
    log(f"phase 52: Sun raster, FLI / FLC, FITS, GBR, McIdas, PIXAR, XPM and XV thumbnail "
        f"decoding without PIL: the fixtures' digests, the 2048^2 albedo as a run-length Sun "
        f"raster, a BRUN FLC and a FITS, the config-3 CLI on the Sun raster [card: {card}]")
    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = {k: v for k, v in json.load(f).items() if k.startswith(RASTER_FIXTURES)}
    formats = {}
    for fname, rec in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, fname), "rb") as f:
            fmt, px = decode_with_format(f.read(), fname)
        formats[fmt] = formats.get(fmt, 0) + 1
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
    check(len(digests) >= 16 and len(formats) == 8,
          f"{len(digests)} raster fixtures of {sorted(formats)}")
    log(f"  {len(digests)} fixtures decoded ({', '.join(f'{k} {v}' for k, v in formats.items())}); "
        f"every SHA-256 equals PIL {', '.join(sorted({r['pil'] for r in digests.values()}))}'s "
        "in digests.json")

    t0 = time.perf_counter()
    files = raster_albedo_files(albedo_png()[1])
    log(f"  wrote the 2048^2 albedo in three forms in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {len(v)} bytes" for k, v in files.items()) + ")")
    with open(GENERATED) as f:
        recorded = json.load(f)
    check(set(files) <= set(recorded), f"wrote {sorted(files)}, the record holds {sorted(recorded)}")
    names = {"ras": "SUN", "flc": "FLI", "fits": "FITS"}
    for fname, data in files.items():
        rec = recorded[fname]
        file_sha = hashlib.sha256(data).hexdigest()
        check(file_sha == rec["file_sha256"],
              f"{fname}: written as sha256 {file_sha[:16]}..., recorded {rec['file_sha256'][:16]}...")
        fmt, px = decode_with_format(data, fname)
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == rec["shape"] and digest == rec["sha256"],
              f"{fname}: decoded {px.shape}, sha256 {digest[:16]}..., PIL's {rec['sha256'][:16]}...")
        check(fmt == names[fname.rsplit(".", 1)[1]], f"{fname} read as {fmt}")
    log(f"  the three files equal the recorded bytes and decode to PIL "
        f"{', '.join(sorted({recorded[k]['pil'] for k in files}))}'s recorded reads")
    out = {}
    png_s, png_runs = png_decode_median()
    out["png_decode_s"] = png_s
    log(f"  2048^2 PNG decode on the host, median of 3 (phase 41's): {png_s:.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in png_runs)}) [card: {card}]")
    for fname, data in files.items():
        med, runs = _median_s(lambda: decode_with_format(data, fname))
        out[f"{fname}_decode_s"] = med
        log(f"  {fname} decode on the host, median of 3: {med:.4f} s ({len(data)} bytes; "
            f"runs {', '.join(f'{t:.4f}' for t in runs)}) [card: {card}]")
    check(out[f"{RASTER_CLI_SUN}_decode_s"] <= png_s,
          f"{RASTER_CLI_SUN} decodes in {out[f'{RASTER_CLI_SUN}_decode_s']:.4f} s, slower than "
          f"the PNG's {png_s:.4f} s")

    frames, cli, _ = config3_cli_runs(card, traversal, cli_render,
                                      {"albedo.ras": files[RASTER_CLI_SUN]}, ("albedo.ras",),
                                      set())
    out.update(cli)
    check(np.array_equal(frames["albedo.ras"], png_frame),
          "the frame on the Sun raster albedo differs from phase 51's PNG route of its pixels")
    log("  the Sun raster albedo's frame is bit-equal to phase 51's PNG route of its pixels")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 52: {out['phase_s']:.1f} s")
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
    native_names = ("bvh", "jpeg", "jpeg_arith", "gif", "tiff", "webp_vp8l", "webp_vp8", "bcn",
                    "qoi", "rle", "zstd", "fax3", "j2k", "lcms", "av1")
    with ThreadPoolExecutor(max_workers=len(KERNELS) + len(native_names)) as pool:
        # g++ beside the nvcc builds: the BVH builder, the JPEG Huffman and
        # arithmetic decoders, the GIF and TIFF LZW decoders, the two WebP decoders, the BCn decoder,
        # the QOI decoder, the SGI / PCX / Sun / FLI / ThunderScan run-length decoder, the ZSTD
        # decoder, the CCITT decoder, the JPEG 2000 decoder and the Lab evaluator
        natives = {n: pool.submit(native_loader.build, n) for n in native_names}
        builds = {kname: pool.submit(kbuild.build, kname) for kname in KERNELS}
        libs = {kname: f.result() for kname, f in builds.items()}
        native_paths = {n: f.result() for n, f in natives.items()}
    for kname in KERNELS:
        kbuild.load(kname)
    for n in native_paths:
        native_loader.load(n)
    build_s = time.perf_counter() - t0
    for kname, path in libs.items():
        log(f"  built {os.path.relpath(path, ROOT)}")
    for n, path in native_paths.items():
        log(f"  built {os.path.relpath(path, ROOT)} (g++, {native_loader.SOURCES[n][2]})")
    log(f"  all builds, in parallel: {build_s:.2f} s")
    htj2k_writer = start_htj2k_albedo()  # phase 53's 2048^2 HT albedo, meanwhile
    for kname, (secs, report) in kbuild.BUILD_LOG.items():
        log(f"  nvcc {kname}: {secs:.2f} s; ptxas:\n    " + report.replace("\n", "\n    "))
    for kname in KERNELS:
        if kname in kbuild.BUILD_LOG:
            log(f"  {kname} registers / stack / spills:\n    "
                + ptxas_summary(kbuild.BUILD_LOG[kname][1]).replace("\n", "\n    "))

    # ---- phase 2: kernel vs plain on the card ---------------------------
    log("phase 2: kernel vs plain PyTorch version on the card")
    sc = cornell_box(256, 256)
    scene = sc.compile(intersector="auto", device=dev)
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
    scene64 = sc64.compile(intersector="auto", device=dev)
    img64 = render(scene64, sc64.camera, PathConfig(spp=4, max_depth=5), seed=0)
    golden = np.load(GOLDEN)
    images_match(img64.cpu().numpy(), golden)

    # ---- phase 5: realistic size ----------------------------------------
    log(f"phase 5: 1024x1024, 16 spp, depth 5 [card: {card}]")
    sc1k = cornell_box(1024, 1024)
    scene1k = sc1k.compile(intersector="auto", device=dev)
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
    scene_t64 = sct.compile(intersector="auto", device=dev)
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
        scene_g = sc_g.compile(device=dev)
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
    s4b = slice4b_phases(dev, card, traversal, scene1k, sc1k, host1m, sc1m, cli_render)
    del host1m
    shard = sharded_phases(dev, card, sc, s4a["bdpt_image"], cli_render, SHARDED)
    # the any-hit rows count every path's launches: the boundary term's side
    # probes and the BDPT connections (dense), occlude_soa, BDPT and AO (tree)
    any_hit_launches["dense"] = grad["boundary_any_hit_launches"] + s4a["bdpt_dense_any_hit"]
    any_hit_launches["tree"] += s4a["bdpt_any_hit"] + s4a["ao_any_hit"]
    # the tree rows' errors also cover the envtex, BDPT and AO paths' own rays,
    # and every kernel's row the sharded paths' per-rank launches
    tree_err = max(tree_err, s4a["tree_err"], shard["tree_errs"][0])
    tree_occ_err = max(tree_occ_err, s4a["tree_occ_err"], shard["tree_errs"][1])
    max_abs_err = max(max_abs_err, shard["dense_errs"][0])
    occ_abs_err = max(occ_abs_err, shard["dense_errs"][1])
    err_it = max(err_it, shard["instanced_tree_errs"][0])
    occ_it = max(occ_it, shard["instanced_tree_errs"][1])
    log(f"  launches on the new paths: bf16 frame {s4b['bf16_dense_closest']} dense closest, "
        f"progressive 64 spp {s4b['progressive_tree_closest']} tree closest, cached-mesh CLI "
        f"{s4b['meshcache_tree_closest']} tree closest, texel step "
        f"{s4b['texel_dense_closest']} dense closest")
    log(f"  launches on the sharded paths, per rank: bench step {shard['step_dense_launches_r2']} "
        f"dense closest, BDPT {shard['bdpt_launches']}, progressive "
        f"{shard['progressive_launches']}")
    aos = bench_phase(dev, card, traversal, scene, sc, scene512, sc512, grad["bench_loss"])
    # the AoS entry points' kernel launches against their plain versions
    max_abs_err = max(max_abs_err, aos["dense"][0])
    occ_abs_err = max(occ_abs_err, aos["dense"][1])
    tree_err = max(tree_err, aos["tree"][0])
    tree_occ_err = max(tree_occ_err, aos["tree"][1])
    err_it = max(err_it, aos["instanced_tree"][0])
    occ_it = max(occ_it, aos["instanced_tree"][1])
    image_phase(card, traversal, cli_render)
    formats42 = format_phase(card, traversal, cli_render)
    tiff43 = tiff_phase(card, traversal, cli_render)
    webp44 = webp_phase(card, traversal, cli_render)
    dds_phase(card, traversal, cli_render)
    legacy46 = legacy_phase(card, traversal, cli_render)
    jpeg_forms_phase(card, traversal, cli_render)
    fax_phase(card, traversal, cli_render)
    j2k = jpeg2000_phase(card, traversal, cli_render)
    lab_phase(card, traversal, cli_render)
    plugins = plugin_phase(card, traversal, cli_render)
    raster_phase(card, traversal, cli_render, plugins["png_frame"])
    from tools.make_torch_port_image_fixtures import ALBEDO_J2K

    for ph, frame in (("42's TGA-RLE and BMP", formats42["frame"]),
                      ("43's LZW and 16-bit TIFF", tiff43["frame"]),
                      ("44's lossless WebP", webp44["frame"]),
                      ("46's RLE SGI and PCX", legacy46["frame"])):
        check(np.array_equal(frame, plugins["png_frame"]),
              f"phase {ph} albedo frames differ from phase 51's PNG route of the same pixels")
        log(f"  phase {ph} albedo frames are bit-equal to phase 51's PNG route's")
    htj2k_phase(card, traversal, cli_render, htj2k_writer, j2k["x32_frame"],
                j2k[f"{ALBEDO_J2K}_decode_s"])
    avif_phase(card, traversal, cli_render)
    tree_err = max(tree_err, plugins["tree_err"])
    tree_occ_err = max(tree_occ_err, plugins["tree_occ_err"])
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # ---- phase 55: result ----------------------------------------------------
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
