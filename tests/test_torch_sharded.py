"""Port parity: ray-sharded rendering over torch.distributed
(``akari_torch/parallel``) against the port's unsharded functions and the
JAX package's ``shard_map`` versions.

The port's ranks are spawned processes (``spawn_ranks``) on a gloo mesh on
the CPU, their workers in tests/_sharded_ranks.py; each multi-rank call
joins with its own timeout (``RANK_TIMEOUT``) and then kills its ranks and
fails. The JAX package's ``render_sharded`` / ``loss_and_image_sharded`` /
``inverse_render`` / ``render_progressive`` on R-device CPU meshes take
minutes each to compile, so their outputs are goldens
(tests/data/torch_port_sharded.npz, tools/make_torch_port_sharded_golden.py)
of the same scenes, configurations and rank counts. Tolerances:

- against the port's unsharded functions: path and AO images bit-equal
  (a pixel's samples are folded and summed alike at these sizes: the
  fold takes min(spp, 2^22 // B) samples, spp here either way); BDPT
  radiance bit-equal and the image within rtol 1e-5, atol 1e-5 (the splat
  films are summed per rank, then across ranks); loss rtol 1e-5 (partial
  sums per rank) and gradients within 1e-5 of max|g|;
- against the JAX package: images by tests/test_torch_path.py's
  full-render budget (outlier_frac 0.08, mean_tol 3e-3), losses rtol 1e-5,
  gradients by ``assert_grad_parity`` within 1e-5 of max|g|; the bf16 dry
  run by tests/test_torch_variant.py's loss rtol 1e-6; the 3-iteration
  ``inverse_render`` and the progressive render by tests/test_torch_inverse.py's
  and tests/test_torch_progressive.py's cross-package tolerances;
- across ranks: every rank's image, loss and gradient bit-equal.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _sharded_ranks as ranks
from _imgcmp import assert_images_match
from _port_diff import assert_grad_parity, both, emissive_texels, port_camera
from akari_torch.diff.inverse import InverseConfig, apply_params, scene_params
from akari_torch.cli.render import main as cli_main
from akari_torch.integrators.ao import AOConfig, render_ao
from akari_torch.integrators.bdpt import BDPTConfig, render_bdpt
from akari_torch.integrators.path import PathConfig, render
from akari_torch.integrators.progressive import render_progressive
from akari_torch.parallel import loss_and_image_sharded, make_ray_mesh, render_sharded
from akari_torch.parallel.launch import RankFailure, spawn_ranks
from akari_torch.parallel.render import loss_and_image
from akari_torch.scene import nodes
from akari_torch.scene.builtin import dryrun_scene
from akari_torch.utils.config import RGB_BF16
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_sharded.npz")
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")
RANK_TIMEOUT = 120.0
FULL_RENDER = dict(outlier_frac=0.08, mean_tol=3e-3)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def box(res):
    """(port scene of the JAX package's brute compile, port camera)."""
    sc = ref_cornell_box(res, res)
    _, port = both(sc.compile(intersector="brute"))
    return port, port_camera(sc.camera)


def run(tmp_path, fn, world_size, *args):
    return spawn_ranks(fn, world_size, args, device="cpu", timeout=RANK_TIMEOUT, threads=1,
                       rendezvous_dir=str(tmp_path))


def assert_same_on_every_rank(outs):
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            np.testing.assert_array_equal(a, b)


def unsharded_loss(scene, cam, cfg, target):
    p = {k: v.requires_grad_(True) for k, v in scene_params(scene).items()}
    loss, img = loss_and_image(apply_params(scene, p), cam, cfg, torch.from_numpy(target))
    loss.backward()
    return float(loss.detach()), img.detach().numpy(), p["tex_value"].grad.numpy()


def test_one_rank_mesh_is_the_unsharded_render():
    """With no process group the mesh has one rank on the caller's device,
    its collectives are the identity, and the sharded functions give the
    unsharded ones' bits."""
    mesh = make_ray_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.device, mesh.group) == (0, 1, torch.device("cpu"), None)
    t = torch.ones(3)
    assert mesh.all_reduce(t) is t
    port, cam = box(7)
    cfg = PathConfig(spp=2, max_depth=2)
    np.testing.assert_array_equal(render_sharded(port, cam, cfg, mesh).numpy(),
                                  render(port, cam, cfg).numpy())
    target = np.full((7, 7, 3), 0.25, np.float32)
    got = ranks.loss_and_grads(mesh, port, cam, cfg, target)
    want = unsharded_loss(port, cam, cfg, target)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_ray_mesh("cuda")


def test_path_r2_matches_unsharded_and_reference(tmp_path, golden):
    """tests/test_parallel.py's fast-tier render (12x12, 1 spp, depth 1) at
    R = 2."""
    port, cam = box(12)
    cfg = PathConfig(spp=1, max_depth=1)
    outs = run(tmp_path, ranks.render, 2, [(port, cam, cfg, 0)])
    assert_same_on_every_rank(outs)
    np.testing.assert_array_equal(outs[0][0], render(port, cam, cfg).numpy())
    assert_images_match(outs[0][0], golden["path12_r2_image"], **FULL_RENDER)


def test_pad_lanes_and_splat_mask_r3(tmp_path, golden):
    """Pad lanes at R = 3: tools/distributed_check.py's 131x131 path frame
    (17,161 pixels, 2 pad lanes) and a 34x34 BDPT frame (1,156 pixels, 2
    pad lanes). A pad lane traces a light subpath too; the lane mask keeps
    its splat off the film, so the frame equals the unsharded one (a pad
    lane that splatted would add light the unsharded frame lacks)."""
    port131, cam131 = box(131)
    port34, cam34 = box(34)
    cfg_p = PathConfig(spp=2, max_depth=3)
    cfg_b = BDPTConfig(spp=1, eye_depth=3, light_depth=2)
    outs = run(tmp_path, ranks.render, 3, [(port131, cam131, cfg_p, 0), (port34, cam34, cfg_b, 0)])
    assert_same_on_every_rank(outs)
    path_img, bdpt_img = outs[0]
    np.testing.assert_array_equal(path_img, render(port131, cam131, cfg_p).numpy())
    np.testing.assert_allclose(bdpt_img, render_bdpt(port34, cam34, cfg_b).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert_images_match(path_img, golden["path131_r3_image"], **FULL_RENDER)
    assert_images_match(bdpt_img, golden["bdpt34_r3_image"], **FULL_RENDER)


def test_ao_r2(tmp_path, golden):
    port, cam = box(12)
    cfg = AOConfig(spp=2)
    outs = run(tmp_path, ranks.render, 2, [(port, cam, cfg, 0)])
    assert_same_on_every_rank(outs)
    np.testing.assert_array_equal(outs[0][0], render_ao(port, cam, cfg).numpy())
    assert_images_match(outs[0][0], golden["ao12_r2_image"], **FULL_RENDER)


@pytest.mark.parametrize("world_size", [2, 4])
def test_loss_and_gradients(tmp_path, golden, world_size):
    """The 13x13 loss (169 pixels: pad lanes at R = 2 and 4) and d loss /
    d tex_value through ``backward()`` alone: equal on every rank, equal
    to the unsharded loss and to jax.grad through shard_map."""
    port, cam = box(13)
    cfg = PathConfig(spp=2, max_depth=2)
    target = np.full((13, 13, 3), 0.25, np.float32)
    outs = run(tmp_path, ranks.loss_and_grads, world_size, port, cam, cfg, target)
    assert_same_on_every_rank(outs)
    loss, img, g = outs[0]
    want_loss, want_img, want_g = unsharded_loss(port, cam, cfg, target)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_array_equal(img, want_img)
    assert_grad_parity(g, want_g, 1e-5)
    key = f"loss13_r{world_size}"
    np.testing.assert_allclose(loss, golden[f"{key}_loss"], rtol=1e-5)
    assert_images_match(img, golden[f"{key}_image"], **FULL_RENDER)
    assert_grad_parity(g, golden[f"{key}_grad"], 1e-5)
    assert np.abs(g).sum() > 0


def test_bdpt_loss_gradient_r2(tmp_path, golden):
    """The splat's backward: rank r's splat reaches every rank's pixels, so
    its cotangent is the ranks' summed; R = 2 against R = 1 (81 pixels, a
    pad lane) and against jax.grad."""
    port, cam = box(9)
    cfg = BDPTConfig(spp=1, eye_depth=2, light_depth=1)
    target = np.full((9, 9, 3), 0.25, np.float32)
    outs = run(tmp_path, ranks.loss_and_grads, 2, port, cam, cfg, target)
    assert_same_on_every_rank(outs)
    loss, img, g = outs[0]
    one = ranks.loss_and_grads(make_ray_mesh("cpu"), port, cam, cfg, target)
    np.testing.assert_allclose(loss, one[0], rtol=1e-5)
    np.testing.assert_allclose(img, one[1], rtol=1e-5, atol=1e-5)
    assert_grad_parity(g, one[2], 1e-5)
    assert_grad_parity(g, unsharded_loss(port, cam, cfg, target)[2], 1e-5)
    np.testing.assert_allclose(loss, golden["bdptloss9_r2_loss"], rtol=1e-5)
    assert_grad_parity(g, golden["bdptloss9_r2_grad"], 1e-5)


def test_dryrun_step_r2(tmp_path, golden):
    """The JAX package's multi-device dry run (two-level instanced floor
    under an env map, bf16, 4 spp, depth 5) at 16x16: loss and gradients
    finite, equal to R = 1 and to jax.grad through shard_map."""
    sc = dryrun_scene(16, 16)
    old = nodes.FLATTEN_MAX_TRIS
    nodes.FLATTEN_MAX_TRIS = 1
    try:
        scene = sc.compile(device="cpu")
    finally:
        nodes.FLATTEN_MAX_TRIS = old
    assert scene.instances is not None and scene.env_image is not None
    cfg = PathConfig(spp=4, max_depth=5, dtypes=RGB_BF16)
    target = np.zeros((16, 16, 3), np.float32)
    outs = run(tmp_path, ranks.loss_and_grads, 2, scene, sc.camera, cfg, target)
    assert_same_on_every_rank(outs)
    loss, _, g = outs[0]
    assert np.isfinite(loss) and np.isfinite(g).all() and np.abs(g).sum() > 0
    one = ranks.loss_and_grads(make_ray_mesh("cpu"), scene, sc.camera, cfg, target)
    np.testing.assert_allclose(loss, one[0], rtol=1e-6)
    assert_grad_parity(g, one[2], 1e-5)
    np.testing.assert_allclose(loss, golden["dryrun16_r2_loss"], rtol=1e-6)
    assert_grad_parity(g, golden["dryrun16_r2_grad"], 1e-5)


def test_inverse_render_r2(tmp_path, golden):
    """3 ``inverse_render`` iterations at R = 2: the losses of R = 1 and of
    the JAX loop on a 2-device mesh, the parameters bit-equal across
    ranks."""
    port, cam = box(12)
    key = "inverse12_r2"
    np.testing.assert_array_equal(
        golden[f"{key}_bad_value"],
        np.where(emissive_texels(port)[:, None], port.textures.value.numpy(),
                 0.4 * port.textures.value.numpy()).astype(np.float32))
    bad = dataclasses.replace(port, textures=dataclasses.replace(
        port.textures, value=torch.from_numpy(golden[f"{key}_bad_value"])))
    cfg = PathConfig(spp=2, max_depth=2)
    icfg = InverseConfig(iterations=3, learning_rate=0.05, seed=7)
    target = golden[f"{key}_target"]
    outs = run(tmp_path, ranks.inverse, 2, bad, cam, cfg, target, icfg)
    assert_same_on_every_rank(outs)
    losses, value, img = outs[0]
    one = ranks.inverse(make_ray_mesh("cpu"), bad, cam, cfg, target, icfg)
    np.testing.assert_allclose(losses, one[0], rtol=1e-5)
    np.testing.assert_allclose(value, one[1], rtol=1e-5)
    np.testing.assert_allclose(losses, golden[f"{key}_losses"], rtol=1e-5)
    np.testing.assert_allclose(value, golden[f"{key}_value"], rtol=1e-5)
    np.testing.assert_allclose(img, golden[f"{key}_image"], rtol=1e-5, atol=1e-6)
    assert losses[-1] < losses[0]


def test_progressive_r2_resume(tmp_path, golden):
    """``render_progressive(mesh=...)`` at R = 2: preempted on every rank
    after the checkpoint at 2 of 4 samples and resumed, bit-equal to the
    uninterrupted sharded run and the unsharded one; rank 0 alone writes."""
    port, cam = box(8)
    cfg = PathConfig(spp=4, max_depth=1)
    kw = dict(seed=3, spp_chunk=1, checkpoint_every=2, progress=False)
    ckpt = str(tmp_path / "render.npz")
    outs = run(tmp_path, ranks.progressive_resume, 2, port, cam, cfg, ckpt, 2, kw)
    for r, (full, resumed, writes, offsets) in enumerate(outs):
        np.testing.assert_array_equal(resumed, full)
        np.testing.assert_array_equal(full, outs[0][0])
        assert offsets == [2, 3]
        assert writes == ([2, 4] if r == 0 else []), (r, writes)
    full = outs[0][0]
    np.testing.assert_array_equal(full, render_progressive(port, cam, cfg, **kw))
    np.testing.assert_allclose(full, golden["progressive8_r2_image"], rtol=1e-5, atol=1e-6)


def test_cli_sharded_under_torchrun(tmp_path):
    """CLI ``--sharded --device cpu`` under ``torch.distributed.run`` with 2
    ranks (17x16: a pad lane): rank 0 writes the same PNG as the unsharded
    CLI."""
    args = ["-i", SCENE_FILE, "--device", "cpu", "--width", "17", "--height", "16",
            "--spp", "1", "--max-depth", "2"]
    sharded, plain = tmp_path / "sharded.png", tmp_path / "plain.png"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
           "-m", "akari_torch.cli.render"] + args + ["-o", str(sharded), "--sharded"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "rank 1 of 2" in out.stderr and "rank 0 of 2" in out.stderr
    assert cli_main(args + ["-o", str(plain)]) == 0
    assert sharded.read_bytes() == plain.read_bytes()


def test_cli_sharded_ao_under_torchrun(tmp_path):
    """``--sharded --ao`` under ``torch.distributed.run`` with 2 ranks: rank 0
    renders unsharded and writes the PNG of the unsharded CLI, rank 1
    returns 0 without rendering, and no ray mesh is made."""
    args = ["-i", SCENE_FILE, "--device", "cpu", "--width", "16", "--height", "16",
            "--spp", "1", "--ao"]
    sharded, plain = tmp_path / "sharded.png", tmp_path / "plain.png"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
           "-m", "akari_torch.cli.render"] + args + ["-o", str(sharded), "--sharded", "-v"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "rank 0 renders" in out.stderr and "ray mesh" not in out.stderr
    assert out.stderr.count("AOConfig render done") == 1
    assert cli_main(args + ["-o", str(plain)]) == 0
    assert sharded.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("integrator", ["ao", "bdpt"])
def test_sharded_cli_renders_ao_and_bdpt_unsharded(tmp_path, integrator):
    """As the reference, which takes the AO / BDPT branch before it reads
    --sharded: exit 0 and the PNG of the same command without --sharded,
    bit for bit (the --ao flag on the Cornell scene, or a Cornell scene
    whose integrator is BDPT)."""
    scene = SCENE_FILE
    args = ["--device", "cpu", "--width", "16", "--height", "16", "--spp", "1"]
    if integrator == "ao":
        args.append("--ao")
    else:
        with open(SCENE_FILE) as f:
            text = f.read()
        obj = os.path.join(os.path.dirname(SCENE_FILE), "CornellBox-Original.obj")
        scene = str(tmp_path / "bdpt.akari")
        with open(scene, "w") as f:
            f.write(text.replace("integrator: Path {", "integrator: BDPT {")
                    .replace('"CornellBox-Original.obj"', f'"{obj}"'))
    sharded, plain = tmp_path / "sharded.png", tmp_path / "plain.png"
    assert cli_main(["-i", scene, "-o", str(sharded), "--sharded"] + args) == 0
    assert cli_main(["-i", scene, "-o", str(plain)] + args) == 0
    assert sharded.read_bytes() == plain.read_bytes()


def test_a_failing_or_stuck_rank_fails_the_call(tmp_path):
    with pytest.raises(RankFailure, match="(?s)rank 1 failed.*rank 1 fails"):
        spawn_ranks(ranks.raise_on_rank_1, 2, device="cpu", timeout=RANK_TIMEOUT,
                    rendezvous_dir=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="timed out"):
        spawn_ranks(ranks.sleep, 2, (60,), device="cpu", timeout=5.0,
                    rendezvous_dir=str(tmp_path))
    assert time.monotonic() - t0 < 40


def test_sharded_modules_import_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "sys.path[:0] = ['tests', 'tools', '.']\n"
        "import akari_torch.parallel, akari_torch.parallel.launch, akari_torch.cli.render\n"
        "import akari_torch.integrators.progressive, akari_torch.diff.inverse\n"
        "import _sharded_ranks, distributed_check_torch, bench_scaling_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'akari_tpu', 'ml_dtypes', 'PIL')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
