"""Port parity: progressive rendering with checkpoint / resume
(``akari_torch/integrators/progressive.py``, ``utils/checkpoint.py``)
against akari_tpu.

The first three tests port tests/test_progressive.py's (there marked
slow for the JAX compile; the port's run in a second at 8x8). Tolerances:
chunked against one pass, and a resumed render against an uninterrupted
one across packages, at that file's rtol 1e-5, atol 1e-6; a render
resumed by the port from its own checkpoint equals the uninterrupted one
bit for bit (the same float operations in the same order); render
checkpoints read across packages equal bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _port_diff import both, port_camera
from akari_torch.integrators import progressive
from akari_torch.integrators.path import PathConfig
from akari_torch.integrators.progressive import render_progressive
from akari_torch.parallel import make_ray_mesh
from akari_torch.scene.builtin import cornell_box
from akari_torch.utils.checkpoint import load_render_state, save_render_state
from akari_tpu.integrators import path as ref_path
from akari_tpu.integrators import progressive as ref_progressive
from akari_tpu.scene.builtin import cornell_box as ref_cornell_box
from akari_tpu.utils import checkpoint as ref_checkpoint

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
META = {"w": 8, "h": 8, "spp": 4, "max_depth": 1}


@pytest.fixture(scope="module")
def box():
    sc = cornell_box(8, 8)
    return sc.compile(intersector="dense", device="cpu"), sc.camera


def test_progressive_matches_full(box):
    scene, cam = box
    cfg = PathConfig(spp=4, max_depth=1)
    img_chunked = render_progressive(scene, cam, cfg, seed=7, spp_chunk=2, progress=False)
    img_once = render_progressive(scene, cam, cfg, seed=7, spp_chunk=4, progress=False)
    np.testing.assert_allclose(img_chunked, img_once, **TOL)
    assert float(np.mean(img_once)) > 0.01
    assert img_once.dtype == np.float32 and img_once.shape == (8, 8, 3)


def test_checkpoint_resume(box, tmp_path):
    scene, cam = box
    cfg = PathConfig(spp=4, max_depth=1)
    ck = str(tmp_path / "render.ckpt.npz")
    full = render_progressive(scene, cam, cfg, seed=3, spp_chunk=2, progress=False)

    # an interrupted run: 2 of 4 samples, checkpointed
    render_progressive(scene, cam, dataclasses.replace(cfg, spp=2), seed=3, spp_chunk=1,
                       checkpoint_path=ck, checkpoint_every=1, progress=False)
    state = load_render_state(ck)
    assert state is not None and state[1] == 2

    # resume requires matching meta; spoof it to the full config
    save_render_state(ck, state[0], state[1], 3, META)
    resumed = render_progressive(scene, cam, cfg, seed=3, spp_chunk=1,
                                 checkpoint_path=ck, progress=False)
    np.testing.assert_allclose(resumed, full, **TOL)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "s.npz")
    acc = np.random.default_rng(0).random((4, 4, 3)).astype(np.float32)
    save_render_state(p, acc, 5, 9, {"k": 1})
    r, n, s, meta = load_render_state(p)
    np.testing.assert_array_equal(r, acc)
    assert (n, s, meta) == (5, 9, {"k": 1})
    assert load_render_state(str(tmp_path / "missing.npz")) is None
    save_render_state(p, torch.from_numpy(acc), 6, 9)  # a tensor accumulator too
    r, n, _, meta = load_render_state(p)
    np.testing.assert_array_equal(r, acc)
    assert (n, meta) == (6, {})


class _Preempted(Exception):
    pass


def test_resumed_render_equals_uninterrupted_bit_for_bit(box, tmp_path, monkeypatch):
    """Preempted just after the checkpoint at 8 of 16 samples, then run
    again with the same arguments: the image equals the uninterrupted
    run's exactly, and the resumed run renders only samples 8-15."""
    scene, cam = box
    cfg = PathConfig(spp=16, max_depth=2)
    kw = dict(seed=11, spp_chunk=2, checkpoint_every=2, progress=False)
    full = render_progressive(scene, cam, cfg, **kw)
    ck = str(tmp_path / "r.npz")
    saved = []

    def save_then_stop(path, acc, done, seed, meta):
        save_render_state(path, acc, done, seed, meta)
        saved.append(done)
        if done == 8:
            raise _Preempted

    monkeypatch.setattr(progressive, "save_render_state", save_then_stop)
    with pytest.raises(_Preempted):
        render_progressive(scene, cam, cfg, checkpoint_path=ck, **kw)
    assert saved == [4, 8] and load_render_state(ck)[1] == 8
    offsets = []
    render = progressive.render
    monkeypatch.setattr(progressive, "render", lambda *a, sample_offset, **k: (
        offsets.append(sample_offset), render(*a, sample_offset=sample_offset, **k))[1])
    resumed = render_progressive(scene, cam, cfg, checkpoint_path=ck, **kw)
    assert offsets == [8, 10, 12, 14] and saved[2:] == [12, 16]
    np.testing.assert_array_equal(resumed, full)


@pytest.mark.parametrize("what", ["seed", "meta"])
def test_mismatched_checkpoint_restarts(box, tmp_path, what):
    scene, cam = box
    cfg = PathConfig(spp=4, max_depth=1)
    fresh = render_progressive(scene, cam, cfg, seed=3, spp_chunk=2, progress=False)
    ck = str(tmp_path / "r.npz")
    junk = np.full((8, 8, 3), 1e3, np.float32)
    if what == "seed":
        save_render_state(ck, junk, 2, 4, META)
    else:
        save_render_state(ck, junk, 2, 3, dict(META, max_depth=2))
    got = render_progressive(scene, cam, cfg, seed=3, spp_chunk=2, checkpoint_path=ck,
                             progress=False)
    np.testing.assert_array_equal(got, fresh)
    assert load_render_state(ck)[1] == 4


def test_checkpoints_read_across_packages(tmp_path):
    acc = np.random.default_rng(1).random((3, 5, 3)).astype(np.float32)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    save_render_state(a, acc, 7, 2, {"w": 5, "h": 3})
    ref_checkpoint.save_render_state(b, acc, 7, 2, {"w": 5, "h": 3})
    for mine, theirs in ((ref_checkpoint.load_render_state(a), load_render_state(a)),
                         (load_render_state(b), ref_checkpoint.load_render_state(b))):
        np.testing.assert_array_equal(mine[0], theirs[0])
        assert mine[0].dtype == np.float32 and mine[1:] == theirs[1:] == (7, 2, {"w": 5, "h": 3})
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume(tmp_path, writer):
    """A render checkpointed at 2 of 4 samples by one package resumes in
    the other: the result is the resuming package's uninterrupted image
    within the cross-package tolerance, and differs from a fresh start on
    a corrupted accumulator (so the checkpoint was used)."""
    sc = ref_cornell_box(8, 8)
    ref, port = both(sc.compile(intersector="brute"))
    cam = port_camera(sc.camera)
    cfg_p, cfg_r = PathConfig(spp=4, max_depth=1), ref_path.PathConfig(spp=4, max_depth=1)
    ck = str(tmp_path / "r.npz")
    if writer == "jax":
        ref_progressive.render_progressive(ref, sc.camera, dataclasses.replace(cfg_r, spp=2),
                                           seed=3, spp_chunk=2, checkpoint_path=ck,
                                           progress=False)
    else:
        render_progressive(port, cam, dataclasses.replace(cfg_p, spp=2), seed=3, spp_chunk=2,
                           checkpoint_path=ck, progress=False)
    acc, done, seed, _ = load_render_state(ck)
    assert done == 2
    save_render_state(ck, acc, done, seed, META)  # the full run's meta
    if writer == "jax":
        got = render_progressive(port, cam, cfg_p, seed=3, spp_chunk=2, checkpoint_path=ck,
                                 progress=False)
    else:
        got = np.asarray(ref_progressive.render_progressive(
            ref, sc.camera, cfg_r, seed=3, spp_chunk=2, checkpoint_path=ck, progress=False))
    want = render_progressive(port, cam, cfg_p, seed=3, spp_chunk=2, progress=False)
    np.testing.assert_allclose(got, want, **TOL)
    assert load_render_state(ck)[1] == 4


def test_progress_bar_and_mesh(box, monkeypatch):
    import functools
    import io

    from akari_torch.utils.progress import ProgressReporter

    scene, cam = box
    buf = io.StringIO()
    monkeypatch.setattr(progressive, "ProgressReporter",
                        functools.partial(ProgressReporter, stream=buf))
    img = render_progressive(scene, cam, PathConfig(spp=2, max_depth=1), spp_chunk=1)
    err = buf.getvalue()
    assert err.startswith("\rrender [") and "100.0%" in err and err.endswith("\n")
    # a 1-rank ray mesh (no process group) renders each chunk through
    # render_sharded: the same image, and its rank 0 reports progress
    buf.truncate(0)
    buf.seek(0)
    sharded = render_progressive(scene, cam, PathConfig(spp=2, max_depth=1), spp_chunk=1,
                                 mesh=make_ray_mesh("cpu"))
    np.testing.assert_array_equal(sharded, img)
    assert "100.0%" in buf.getvalue()
