"""Write the goldens the PyTorch port's ray-sharded functions are checked against.

Runs the JAX package's (``akari_tpu``) sharded functions on R-device CPU
meshes (``make_ray_mesh(n_devices=R)`` over
``--xla_force_host_platform_device_count=8``) and saves their outputs in
one ``.npz``, ``tests/data/torch_port_sharded.npz``, whose keys are
``<case>_<output>``. ``tests/test_torch_sharded.py`` runs the same cases
with ``akari_torch``'s ranks over gloo. Each case compiles its own
``shard_map`` program (minutes each on the CPU), so the cases run in
parallel processes. The Cornell boxes are compiled with the brute-force
intersector, as ``tests/_port_diff.py::both`` hands them to the port; the
dry run's scene on ``auto`` (the two-level XLA traversal on the CPU).

Cases (seed 0 unless named):

- ``path12_r2``: ``render_sharded``, Cornell 12x12, PathConfig(spp=1,
  max_depth=1), R = 2 (tests/test_parallel.py's fast-tier render);
- ``path131_r3``: Cornell 131x131 (17,161 pixels, pad 2), PathConfig(spp=2,
  max_depth=3), R = 3 (tools/distributed_check.py's path frame);
  ``bdpt34_r3``: Cornell 34x34 (1,156 pixels, pad 2: the splat lane
  mask), BDPTConfig(spp=1, eye_depth=3, light_depth=2), R = 3;
- ``ao12_r2``: Cornell 12x12, AOConfig(spp=2), R = 2;
- ``loss13_r2``, ``loss13_r4``: ``loss_and_image_sharded`` and
  ``jax.grad`` with respect to ``tex_value``, Cornell 13x13 (169 pixels:
  pad lanes), PathConfig(spp=2, max_depth=2), target 0.25;
- ``bdptloss9_r2``: the same with BDPTConfig(spp=1, eye_depth=2,
  light_depth=1) on the 9x9 Cornell box, R = 2;
- ``dryrun16_r2``: the multi-device dry run's step (``__graft_entry__.py``:
  two-level instanced floor, emitter and env map, bf16, 4 spp, depth 5,
  zero target) at 16x16, R = 2;
- ``inverse12_r2``: ``inverse_render`` for 3 iterations (lr 0.05, seed 7)
  from the non-emissive texels at 0.4x, PathConfig(spp=2, max_depth=2), to
  the 12x12 Cornell box's render at seed 123 (saved as ``target``), R = 2;
- ``progressive8_r2``: ``render_progressive`` of the 8x8 Cornell box,
  PathConfig(spp=4, max_depth=1), seed 3, ``spp_chunk=1``, R = 2.

Usage: python tools/make_torch_port_sharded_golden.py [-o PATH] [--jobs N]
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_sharded.npz")
CASES = ("path12_r2", "path131_r3", "bdpt34_r3", "ao12_r2", "loss13_r2", "loss13_r4",
         "bdptloss9_r2", "dryrun16_r2", "inverse12_r2", "progressive8_r2")


def _dryrun_scene(res):
    """The dry run's scene (``__graft_entry__.py:54-89``) at res x res,
    compiled two-level as the dry run compiles it."""
    import numpy as np

    import akari_tpu.scene.nodes as nodes_mod
    from akari_tpu.core import transform as xform
    from akari_tpu.scene.arrays import make_camera
    from akari_tpu.scene.nodes import (
        DiffuseMaterial, EmissiveMaterial, EnvMapLight, Instance, Mesh, Scene,
    )

    def quad(y, half, mat):
        v = np.asarray([[-half, y, -half], [half, y, -half], [half, y, half],
                        [-half, y, half]], np.float32)
        return Mesh(vertices=v, indices=np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
                    materials=[mat])

    proto = quad(0.0, 1.5, DiffuseMaterial((0.7, 0.6, 0.5)))
    emitter = quad(4.0, 0.5, EmissiveMaterial((6.0, 6.0, 6.0), double_sided=True))
    env = np.full((8, 16, 3), 0.08, np.float32)
    env[2, 4] = (12.0, 10.0, 8.0)
    insts = [Instance(proto, np.asarray(xform.translate((dx, 0.0, 0.0)), np.float32))
             for dx in (-1.5, 1.5)] + [emitter]
    cam = make_camera(xform.translate((0.0, 2.5, 0.0)) @ xform.rotate_x(np.radians(-90.0)),
                      60.0, res, res)
    old = nodes_mod.FLATTEN_MAX_TRIS
    nodes_mod.FLATTEN_MAX_TRIS = 1
    try:
        scene = Scene(shapes=insts, camera=cam, environment=EnvMapLight(env)).compile(
            intersector="auto")
    finally:
        nodes_mod.FLATTEN_MAX_TRIS = old
    assert scene.instances is not None and scene.env_image is not None
    return scene, cam


def run_case(name):
    """{output name: array} of one case."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from akari_tpu.diff import inverse as inv
    from akari_tpu.integrators.ao import AOConfig
    from akari_tpu.integrators.bdpt import BDPTConfig
    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.integrators.progressive import render_progressive
    from akari_tpu.parallel.mesh import make_ray_mesh
    from akari_tpu.parallel.render import loss_and_image_sharded, render_sharded
    from akari_tpu.scene.arrays import MAT_EMISSIVE
    from akari_tpu.scene.builtin import cornell_box
    from akari_tpu.utils.config import RGB_BF16

    r = int(name.rsplit("_r", 1)[1])
    mesh = make_ray_mesh(n_devices=r)

    def box(res):
        sc = cornell_box(res, res)
        return sc.compile(intersector="brute"), sc.camera

    def loss_grad(scene, cam, cfg, target):
        def f(params):
            return loss_and_image_sharded(inv.apply_params(scene, params), cam, cfg, mesh,
                                          target, seed=0)

        (loss, img), g = jax.jit(jax.value_and_grad(f, has_aux=True))(inv.scene_params(scene))
        return {"loss": np.float64(loss), "image": img, "grad": g["tex_value"]}

    render_cases = {
        "path12_r2": (12, PathConfig(spp=1, max_depth=1)),
        "path131_r3": (131, PathConfig(spp=2, max_depth=3)),
        "bdpt34_r3": (34, BDPTConfig(spp=1, eye_depth=3, light_depth=2)),
        "ao12_r2": (12, AOConfig(spp=2)),
    }
    if name in render_cases:
        res, cfg = render_cases[name]
        scene, cam = box(res)
        out = {"image": render_sharded(scene, cam, cfg, mesh, seed=0)}
    elif name.startswith("loss13"):
        scene, cam = box(13)
        out = loss_grad(scene, cam, PathConfig(spp=2, max_depth=2),
                        jnp.full((13, 13, 3), 0.25, jnp.float32))
    elif name == "bdptloss9_r2":
        scene, cam = box(9)
        out = loss_grad(scene, cam, BDPTConfig(spp=1, eye_depth=2, light_depth=1),
                        jnp.full((9, 9, 3), 0.25, jnp.float32))
    elif name == "dryrun16_r2":
        scene, cam = _dryrun_scene(16)
        out = loss_grad(scene, cam, PathConfig(spp=4, max_depth=5, dtypes=RGB_BF16),
                        jnp.zeros((16, 16, 3), jnp.float32))
    elif name == "inverse12_r2":
        scene, cam = box(12)
        cfg = PathConfig(spp=2, max_depth=2)
        target = render(scene, cam, cfg, seed=123)
        em = np.zeros(scene.textures.value.shape[0], bool)
        kind = np.asarray(scene.materials.kind)
        em[np.asarray(scene.materials.color_tex)[kind == MAT_EMISSIVE]] = True
        value = np.asarray(scene.textures.value)
        bad = np.where(em[:, None], value, 0.4 * value).astype(np.float32)
        # a fresh array: the reference's step donates its parameters
        bad_scene = inv.apply_params(scene, {"tex_value": jnp.array(bad)})
        rec, losses, img = inv.inverse_render(
            bad_scene, cam, cfg, target, mesh,
            inv.InverseConfig(iterations=3, learning_rate=0.05, seed=7))
        out = {"target": target, "bad_value": bad, "losses": np.asarray(losses, np.float64),
               "value": rec.textures.value, "image": img}
    elif name == "progressive8_r2":
        scene, cam = box(8)
        out = {"image": render_progressive(scene, cam, PathConfig(spp=4, max_depth=1), seed=3,
                                           spp_chunk=1, progress=False, mesh=mesh)}
    else:
        raise ValueError(f"unknown case {name!r}")
    out = {k: np.asarray(v) for k, v in out.items()}
    for k, v in out.items():
        if not np.all(np.isfinite(v)):
            raise SystemExit(f"{name}: {k} is not finite")
    return name, out


def _init():
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    ap.add_argument("--jobs", type=int, default=5, help="cases compiled at once")
    args = ap.parse_args(argv)
    import numpy as np

    arrays = {}
    with mp.get_context("spawn").Pool(args.jobs, initializer=_init) as pool:
        for name, out in pool.imap_unordered(run_case, CASES):
            print(f"{name}: " + ", ".join(f"{k} {v.shape}" for k, v in out.items()), flush=True)
            arrays.update({f"{name}_{k}": v for k, v in out.items()})
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    np.savez_compressed(args.output, **arrays)
    print(f"wrote {args.output}: {len(arrays)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
