"""Shared set-up of the port's gradient tests (tests/test_torch_diff.py,
test_torch_boundary.py, test_torch_inverse.py): one scene compiled by the
JAX package and handed to both packages, and the reference's bench loss on
a 1-device mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from akari_torch.scene.arrays import MAT_EMISSIVE, MAT_GLOSSY, from_numpy_scene, make_camera
from akari_tpu.diff.inverse import apply_params as ref_apply_params
from akari_tpu.parallel.mesh import make_ray_mesh
from akari_tpu.parallel.render import loss_and_image_sharded

F32 = np.float32


def port_camera(cam):
    """The port's camera equal to a reference camera (fov from the stored
    tan(fov / 2), checked to round to the same float32)."""
    fov = float(np.degrees(2.0 * np.arctan(np.float64(cam.tan_half_fov))))
    c = make_camera(np.asarray(cam.c2w), fov, cam.width, cam.height,
                    cam.lens_radius, cam.focal_distance)
    assert np.float32(c.tan_half_fov) == np.float32(cam.tan_half_fov)
    return c


def both(ref_compiled, mutate=None, intersector="brute"):
    """(reference scene as jnp arrays, the port's CPU scene) of one JAX
    compile; ``mutate(numpy scene) -> numpy scene`` edits it first."""
    ref_np = jax.tree_util.tree_map(np.asarray, ref_compiled)
    if mutate is not None:
        ref_np = mutate(ref_np)
    return (jax.tree_util.tree_map(jnp.asarray, ref_np),
            from_numpy_scene(ref_np, intersector=intersector, device="cpu"))


def largest_material(ref_np):
    return int(np.argmax(np.bincount(np.asarray(ref_np.mat_id),
                                     minlength=len(ref_np.materials.kind))))


def make_glossy(ref_np, mat=None):
    """The most used material (or ``mat``) turned glossy on a new
    roughness texel of exactly 1.0 (alpha on its clip bound): the next
    direction then depends on a texel."""
    mats, tex = ref_np.materials, ref_np.textures
    kind, rough = np.array(mats.kind), np.array(mats.roughness_tex)
    value = np.array(tex.value)
    k = largest_material(ref_np) if mat is None else mat
    kind[k] = MAT_GLOSSY
    rough[k] = value.shape[0]
    value = np.concatenate([value, np.ones((1, 3), F32)])
    return dataclasses.replace(
        ref_np, materials=dataclasses.replace(mats, kind=kind, roughness_tex=rough),
        textures=dataclasses.replace(tex, value=value))


def emissive_texels(scene_np):
    """Bool [X]: texels that color an emissive material."""
    kind = np.asarray(scene_np.materials.kind)
    em = np.zeros(np.asarray(scene_np.textures.value).shape[0], bool)
    em[np.asarray(scene_np.materials.color_tex)[kind == MAT_EMISSIVE]] = True
    return em


def ref_loss_fn(ref, cam, cfg, target, seed=0):
    """params -> the reference's bench loss (loss_and_image_sharded on a
    1-device mesh)."""
    mesh = make_ray_mesh(n_devices=1)

    def f(params):
        loss, _ = loss_and_image_sharded(ref_apply_params(ref, params), cam, cfg, mesh,
                                         jnp.asarray(target), seed=seed)
        return loss

    return f


def take_gathers(monkeypatch):
    """Make the reference gather its table rows with ``jnp.take``, as the
    port does, instead of its one-hot matmul (a TPU workaround the port
    does not carry). The forward values are the same (the one-hot product
    is exact); the backward differs where a lane's cotangent is NaN: the
    matmul's transpose multiplies it by 0 into every row of the table,
    the take's scatter-add only into the lane's own row."""
    from akari_tpu.ops import gather

    monkeypatch.setattr(gather, "gather_rows", lambda t, ids: jnp.take(t, ids, axis=0))
    monkeypatch.setattr(gather, "gather_rows_t", lambda t, ids: jnp.take(t, ids, axis=0).T)


def assert_rel_close(g, want, rel):
    """Every entry within ``rel * max|want|``."""
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(g, want, rtol=0, atol=rel * scale)


def assert_grad_parity(g, want, rel):
    """Entries NaN exactly where ``want`` is NaN, the rest within
    ``rel * max|want|``."""
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
    scale = float(np.nanmax(np.abs(want)))
    assert scale > 0
    np.testing.assert_allclose(g, want, rtol=0, atol=rel * scale, equal_nan=True)


def port_value_and_grad(loss_fn, params):
    """(loss float, {key: grad numpy}) of ``loss_fn(params)``, params a dict
    of numpy arrays made into leaf tensors."""
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(leaves, grads)}
