"""Rank workers of tests/test_torch_sharded.py: each runs in a process
spawned by ``akari_torch.parallel.launch.spawn_ranks`` with a gloo ray mesh
on the CPU, and returns NumPy values. Imports only ``akari_torch``."""

import time

import torch

from akari_torch.diff.inverse import apply_params, inverse_render, scene_params
from akari_torch.integrators import progressive
from akari_torch.parallel import loss_and_image_sharded, render_sharded


def render(mesh, jobs):
    """[render_sharded image] for each (scene, camera, cfg, seed) job."""
    return [render_sharded(scene.to(mesh.device), cam, cfg, mesh, seed=seed).numpy()
            for scene, cam, cfg, seed in jobs]


def loss_and_grads(mesh, scene, cam, cfg, target, seed=0):
    """(loss, image, d loss / d tex_value) of ``loss_and_image_sharded``,
    through ``backward()`` alone."""
    p = {k: v.requires_grad_(True) for k, v in scene_params(scene).items()}
    loss, img = loss_and_image_sharded(apply_params(scene, p), cam, cfg, mesh,
                                       torch.from_numpy(target), seed=seed)
    loss.backward()
    return float(loss.detach()), img.detach().numpy(), p["tex_value"].grad.numpy()


def inverse(mesh, scene, cam, cfg, target, icfg):
    """(losses, recovered tex_value, final image) of ``inverse_render``."""
    rec, losses, img = inverse_render(scene, cam, cfg, torch.from_numpy(target), icfg, mesh=mesh)
    return losses, rec.textures.value.numpy(), img.numpy()


class Preempted(Exception):
    pass


def progressive_resume(mesh, scene, cam, cfg, ckpt, stop_at, kw):
    """(uninterrupted image, resumed image, this rank's checkpoint writes,
    the resumed run's sample offsets): every rank is preempted as it
    starts the chunk at ``stop_at`` samples, after the checkpoint there,
    then runs again with the same arguments."""
    full = progressive.render_progressive(scene, cam, cfg, mesh=mesh, **kw)
    writes, offsets, preempt = [], [], [True]
    save, shard = progressive.save_render_state, progressive.render_sharded

    def counted_save(*a):
        writes.append(a[2])
        save(*a)

    def stop_at_chunk(*a, sample_offset, **k):
        if preempt[0] and sample_offset == stop_at:
            raise Preempted
        offsets.append(sample_offset)
        return shard(*a, sample_offset=sample_offset, **k)

    progressive.save_render_state = counted_save
    progressive.render_sharded = stop_at_chunk
    try:
        try:
            progressive.render_progressive(scene, cam, cfg, mesh=mesh, checkpoint_path=ckpt, **kw)
            raise AssertionError("the run was not preempted")
        except Preempted:
            pass
        preempt[0] = False
        offsets.clear()
        resumed = progressive.render_progressive(scene, cam, cfg, mesh=mesh,
                                                 checkpoint_path=ckpt, **kw)
    finally:
        progressive.save_render_state, progressive.render_sharded = save, shard
    return full, resumed, writes, offsets


def raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    mesh.all_reduce(torch.ones(1))  # rank 0 waits here until it is killed
    return mesh.rank


def sleep(mesh, seconds):
    time.sleep(seconds)
