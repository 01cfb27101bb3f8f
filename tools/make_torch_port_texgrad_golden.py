"""Write the texel-gradient golden the PyTorch port is checked against
without JAX.

Builds the textured Cornell box (``akari_torch.scene.builtin``'s recipe:
every diffuse albedo one seeded 64x64 checker image, planar uvs) from the
JAX package's own nodes, renders it at 64x64, 4 spp, depth 3, NEE + MIS,
seed 0 on the CPU through the brute-force intersector, and saves the JAX
package's bench loss (``loss_and_image_sharded`` on a 1-device mesh
against a zero target) and its gradient with respect to
``TextureTable.value`` and ``TextureTable.images`` as
``tests/data/torch_port_texgrad_cornell64.npz`` (``loss`` float32 [],
``grad_tex_value`` [X, 3], ``grad_tex_images`` [I, Hm, Wm, 3], and the
configuration). ``chip_smoke.py`` phase 32 computes the same with
``akari_torch`` on the card and compares.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_texgrad_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_texgrad_cornell64.npz")
WIDTH = HEIGHT = 64
SPP, MAX_DEPTH, SEED = 4, 3, 0
TEX_RES, TEX_SEED = 64, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import jax
    import jax.numpy as jnp
    import numpy as np

    import akari_tpu.scene.nodes as ref_nodes
    from akari_torch.scene.builtin import checker_texture, texture_cornell_mesh
    from akari_tpu.diff.inverse import apply_params, scene_params
    from akari_tpu.integrators.path import PathConfig
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import loss_and_image_sharded
    from akari_tpu.scene.builtin import cornell_box

    sc = cornell_box(WIDTH, HEIGHT)
    texture_cornell_mesh(sc.shapes[0], checker_texture(TEX_RES, TEX_SEED), nodes=ref_nodes)
    scene = sc.compile(intersector="brute")
    cfg = PathConfig(spp=SPP, max_depth=MAX_DEPTH, mis=True)
    mesh = make_ray_mesh(n_devices=1)
    target = jnp.zeros((HEIGHT, WIDTH, 3), jnp.float32)

    def loss_fn(params):
        loss, _ = loss_and_image_sharded(apply_params(scene, params), sc.camera, cfg, mesh,
                                         target, seed=SEED)
        return loss

    params = scene_params(scene, optimize_images=True)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    g_val = np.asarray(grads["tex_value"], np.float32)
    g_img = np.asarray(grads["tex_images"], np.float32)
    loss = np.float32(loss)
    if not (np.isfinite(loss) and np.isfinite(g_val).all() and np.isfinite(g_img).all()):
        raise SystemExit("reference loss or gradient is not finite")
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    np.savez(args.output, loss=loss, grad_tex_value=g_val, grad_tex_images=g_img,
             config=np.asarray([WIDTH, HEIGHT, SPP, MAX_DEPTH, SEED, TEX_RES, TEX_SEED],
                               np.int32))
    print(f"wrote {args.output}: loss {float(loss):.8g}, grad_tex_images {g_img.shape}, "
          f"max |g| {float(np.abs(g_img).max()):.6g}, nonzero texels "
          f"{int((np.abs(g_img).sum(-1) > 0).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
