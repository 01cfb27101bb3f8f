"""The port's render CLI and its PIL-free PNG writer.

The CLI test renders the bundled SDL Cornell box on the CPU at 16x16 and
reads the PNG back with PIL. The writer is checked against the JAX
package's PIL-based writer: decoded pixels must be equal exactly (the same
sRGB quantisation of the same image)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from akari_torch.cli.render import main
from akari_torch.core.image import write_hdr_npy, write_png
from akari_tpu.core.image import write_png as ref_write_png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")


def test_cli_cpu_writes_png(tmp_path):
    out = tmp_path / "out.png"
    rc = main([
        "-i", SCENE_FILE, "-o", str(out), "--device", "cpu",
        "--width", "16", "--height", "16", "--spp", "1", "--max-depth", "2",
    ])
    assert rc == 0
    img = np.asarray(Image.open(out).convert("RGB"))
    assert img.shape == (16, 16, 3)
    assert img.mean() > 20  # lit, not near-black


def test_cli_brute_intersector_matches_dense(tmp_path):
    args = ["-i", SCENE_FILE, "--device", "cpu", "--width", "12",
            "--height", "12", "--spp", "1", "--max-depth", "2"]
    a, b = tmp_path / "dense.png", tmp_path / "brute.png"
    assert main(args + ["-o", str(a), "--intersector", "dense"]) == 0
    assert main(args + ["-o", str(b), "--intersector", "brute"]) == 0
    pa = np.asarray(Image.open(a)).astype(int)
    pb = np.asarray(Image.open(b)).astype(int)
    assert np.abs(pa - pb).max() <= 1


def test_cli_cuda_without_card_fails_clearly(tmp_path, caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would render")
    out = tmp_path / "out.png"
    rc = main(["-i", SCENE_FILE, "-o", str(out), "--device", "cuda",
               "--width", "8", "--height", "8", "--spp", "1"])
    assert rc != 0
    assert not out.exists()
    assert "no CUDA device" in caplog.text


def test_cli_missing_scene_fails(tmp_path):
    assert main(["-i", str(tmp_path / "nope.akari"), "--device", "cpu"]) == 1


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 16)])
def test_png_writer_matches_pil_writer(tmp_path, shape):
    r = np.random.default_rng(sum(shape))
    img = r.uniform(-0.1, 1.5, shape + (3,)).astype(np.float32)
    img[0, 0] = [np.nan, 0.0, 1e9]
    write_png(tmp_path / "port.png", np.nan_to_num(img))
    ref_write_png(str(tmp_path / "ref.png"), np.nan_to_num(img))
    a = np.asarray(Image.open(tmp_path / "port.png"))
    b = np.asarray(Image.open(tmp_path / "ref.png"))
    assert a.shape == shape + (3,)
    np.testing.assert_array_equal(a, b)


def test_hdr_npy_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((4, 5, 3)).astype(np.float32)
    write_hdr_npy(tmp_path / "x.npy", img)
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), img)


def _fake_cards(monkeypatch, count):
    """``cuda`` seen with ``count`` cards on a machine without one."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("cards", [2, 3])
def test_sharded_run_directly_spawns_one_rank_a_card(monkeypatch, tmp_path, cards):
    """Run directly with more than one card, ``--sharded`` asks for one
    rank a card, as the reference's make_ray_mesh() spans every local
    device; rank 0's function renders its share and writes the image
    (run here on a 1-rank CPU mesh: the same PNG as the unsharded CPU CLI)."""
    from akari_torch.parallel import launch
    from akari_torch.parallel.mesh import make_ray_mesh

    args = ["-i", SCENE_FILE, "--width", "8", "--height", "8", "--spp", "1",
            "--max-depth", "2"]
    plain = tmp_path / "plain.png"
    assert main(args + ["-o", str(plain), "--device", "cpu"]) == 0
    _fake_cards(monkeypatch, cards)
    asked = []

    def fake_spawn(fn, world_size, args=(), **kw):
        asked.append((world_size, kw["device"]))
        return [fn(make_ray_mesh("cpu"), *args)] + [0] * (world_size - 1)

    monkeypatch.setattr(launch, "spawn_ranks", fake_spawn)
    out = tmp_path / "sharded.png"
    assert main(args + ["-o", str(out), "--device", "cuda", "--sharded"]) == 0
    assert asked == [(cards, "cuda")]
    assert out.read_bytes() == plain.read_bytes()


def test_sharded_on_one_card_renders_unspawned(monkeypatch, tmp_path):
    """With one card (or under torch.distributed.run) nothing is spawned:
    the CLI renders on its own 1-rank mesh."""
    from akari_torch.parallel import launch, mesh

    _fake_cards(monkeypatch, 1)
    assert launch.local_ranks("cuda") == 1 and launch.local_ranks("cpu") == 1

    def no_spawn(*a, **kw):
        raise AssertionError("spawned ranks on one card")

    monkeypatch.setattr(launch, "spawn_ranks", no_spawn)
    cpu_mesh = mesh.make_ray_mesh("cpu")
    monkeypatch.setattr(mesh, "make_ray_mesh", lambda device: cpu_mesh)
    out = tmp_path / "out.png"
    assert main(["-i", SCENE_FILE, "-o", str(out), "--device", "cuda", "--sharded",
                 "--width", "8", "--height", "8", "--spp", "1", "--max-depth", "2"]) == 0
    assert out.exists()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert launch.local_ranks("cuda") == 1
