"""Write the gradient golden the PyTorch port is checked against without JAX.

Computes the JAX package's bench loss (``loss_and_image_sharded`` on a
1-device mesh: the mean-squared pixel loss against a zero target) and its
gradient with respect to ``TextureTable.value`` for the built-in Cornell
box at 64x64, 4 spp, depth 5, NEE + MIS, seed 0, on the CPU through the
brute-force intersector, and saves them as
``tests/data/torch_port_grad_cornell64_spp4_d5.npz`` (``loss`` float32 [],
``grad_tex_value`` float32 [X, 3], and the configuration). ``chip_smoke.py``
computes the same with ``akari_torch`` on the GPU and compares.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_grad_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_grad_cornell64_spp4_d5.npz")
WIDTH = HEIGHT = 64
SPP, MAX_DEPTH, SEED = 4, 5, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from akari_tpu.diff.inverse import apply_params, scene_params
    from akari_tpu.integrators.path import PathConfig
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import loss_and_image_sharded
    from akari_tpu.scene.builtin import cornell_box

    sc = cornell_box(WIDTH, HEIGHT)
    scene = sc.compile(intersector="brute")
    cfg = PathConfig(spp=SPP, max_depth=MAX_DEPTH, mis=True)
    mesh = make_ray_mesh(n_devices=1)
    target = jnp.zeros((HEIGHT, WIDTH, 3), jnp.float32)

    def loss_fn(params):
        loss, _ = loss_and_image_sharded(apply_params(scene, params), sc.camera, cfg, mesh,
                                         target, seed=SEED)
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(scene_params(scene))
    grad = np.asarray(grads["tex_value"], np.float32)
    loss = np.float32(loss)
    if not (np.isfinite(loss) and np.all(np.isfinite(grad))):
        raise SystemExit("reference loss or gradient is not finite")
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    np.savez(args.output, loss=loss, grad_tex_value=grad,
             config=np.asarray([WIDTH, HEIGHT, SPP, MAX_DEPTH, SEED], np.int32))
    print(f"wrote {args.output}: loss {float(loss):.8g}, grad {grad.shape}, "
          f"max |grad| {float(np.abs(grad).max()):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
