"""The port's device rule: entry points that create tensors from host data
alone run on the card unless the caller asks for the CPU.

- ``Scene.compile``, ``compile_scene``, ``from_numpy_scene``, a torch
  ``Film`` and the ray mesh default to ``cuda`` and never fall back:
  without a CUDA device they raise ``RuntimeError`` naming
  ``device="cpu"`` (on a machine with a card they return CUDA tensors).
- ``compile(..., device="cpu")`` gives the tensors of the CPU compile from
  before the device argument, bit for bit: every field of the Cornell box,
  the n = 64 terrain (tree route) and the two-level dry-run scene against
  ``tests/data/torch_port_compile_digests.json``
  (``tools/make_torch_port_compile_digests.py``).
- The functions that stay on the host by design return no tensors:
  ``make_camera`` (host metadata), the built-in scene helpers and the
  loaders (nodes of NumPy arrays), ``envtex_texture`` and ``read_image``
  (NumPy), the NumPy ``Film``.
"""

import json
import os

import numpy as np
import pytest
import torch

from akari_torch.core.film import Film
from akari_torch.parallel.mesh import make_ray_mesh
from akari_torch.scene import builtin
from akari_torch.scene.arrays import SceneArrays, from_numpy_scene, make_camera
from akari_torch.scene.nodes import compile_scene
from tools.make_torch_port_compile_digests import SCENES, compile_named, scene_digest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGESTS = os.path.join(ROOT, "tests", "data", "torch_port_compile_digests.json")


def _numpy_compiled():
    """A reference-shaped compiled scene of NumPy arrays (the port's own
    CPU compile, read back)."""
    from types import SimpleNamespace

    sc = builtin.cornell_box(4, 4).compile(device="cpu")

    def ns(obj):
        if isinstance(obj, torch.Tensor):
            return obj.numpy()
        if hasattr(obj, "__dataclass_fields__"):
            return SimpleNamespace(**{k: ns(getattr(obj, k)) for k in obj.__dataclass_fields__})
        return obj

    return ns(sc)


ENTRY_POINTS = {
    "Scene.compile": lambda **kw: builtin.cornell_box(4, 4).compile(**kw),
    "compile_scene": lambda **kw: compile_scene(builtin.cornell_box(4, 4).shapes, **kw),
    "from_numpy_scene": lambda **kw: from_numpy_scene(_numpy_compiled(), **kw),
    "Film.zeros": lambda **kw: Film.zeros(2, 3, xp=torch, **kw),
    "make_ray_mesh": lambda **kw: make_ray_mesh(**kw),
}


def _device_of(out):
    if isinstance(out, SceneArrays):
        return out.device
    if isinstance(out, Film):
        return out.radiance.device
    return out.device


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda_without_fallback(entry):
    make = ENTRY_POINTS[entry]
    if torch.cuda.is_available():
        assert _device_of(make()).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
            make()
    assert _device_of(make(device="cpu")).type == "cpu"


@pytest.mark.parametrize("name", SCENES)
def test_cpu_compile_is_bit_equal_to_the_compile_before_the_device_argument(name):
    with open(DIGESTS) as f:
        want = json.load(f)[name]
    scene = compile_named(name, device="cpu")
    assert scene_digest(scene) == want
    assert all(v["device"] == "cpu" for v in want.values() if isinstance(v, dict))
    assert set(scene.compile_seconds) == {"bvh", "tree", "total"}


def test_compile_refuses_bad_input_after_the_device_check():
    """The device is checked first; on the CPU the compile's own errors
    stay as they were."""
    with pytest.raises(TypeError, match="expected Mesh or Instance"):
        compile_scene([object()], device="cpu")
    with pytest.raises(ValueError, match="intersector 'pallas'"):
        builtin.cornell_box(4, 4).compile(intersector="pallas", device="cpu")


def test_host_only_functions_return_no_tensors(tmp_path):
    from akari_torch.core.image import encode_png, read_image
    from akari_torch.scene.obj import load_obj

    cam = make_camera(np.eye(4), 40.0, 8, 8)
    assert isinstance(cam.c2w, np.ndarray) and isinstance(cam.tan_half_fov, np.float32)
    for sc in (builtin.cornell_box(4, 4), builtin.terrain_scene(4, 4, n=8),
               builtin.dryrun_scene(4, 4), builtin.textured_cornell_box(4, 4, tex_res=8)):
        for shape in sc.shapes:
            mesh = getattr(shape, "mesh", shape)
            assert isinstance(np.asarray(mesh.vertices), np.ndarray)
            assert not isinstance(mesh.vertices, torch.Tensor)
    tex = builtin.envtex_texture(16, 0)
    assert isinstance(tex, np.ndarray) and tex.dtype == np.uint8
    (tmp_path / "t.png").write_bytes(encode_png(tex))
    assert isinstance(read_image(str(tmp_path / "t.png")), np.ndarray)
    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assert isinstance(load_obj(str(tmp_path / "m.obj")).vertices, np.ndarray)
    assert isinstance(Film.zeros(2, 3).radiance, np.ndarray)
