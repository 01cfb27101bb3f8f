"""CUDA kernel tests of the port: they need the card and skip without one.

Run on a machine with a CUDA device (no JAX needed):

    python -m pytest tests/test_torch_kernels_gpu.py -q

Tolerance: none. The kernel is built with --fmad=false and follows the
plain version's operation order, so outputs are equal bit for bit.
"""

import pytest
import torch

from akari_torch.core.v3 import V3
from akari_torch.integrators.path import PathConfig, trace_paths
from akari_torch.ops import dense_intersect as di
from akari_torch.scene.builtin import cornell_box

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dense kernel runs only on the card")
    return torch.device("cuda", 0)


def _rays(n, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand((n, 3), generator=g, device=dev) * 1.8 - 0.9
    o[:, 1] += 1.0
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((n,), di.T_MAX, device=dev)
    t_max[::3] = 0.0
    t_max[1::3] = 0.3
    zero = torch.zeros(n, device=dev)
    return di.pack_rays(V3(*o.T), V3(*d.T), zero, t_max).contiguous()


@pytest.mark.parametrize("n", [1, 255, 257, 5000])
def test_closest_and_any_hit_equal_plain(dev, n):
    tris = cornell_box(8, 8).compile().to(dev).prim_table
    rays = _rays(n, dev)
    before = dict(di.LAUNCHES)
    got = di.closest(rays, tris)
    want = di.closest_plain(rays, tris)
    occ = di.any_hit(rays, tris)
    torch.cuda.synchronize()
    assert di.LAUNCHES["closest"] == before["closest"] + 1
    assert di.LAUNCHES["any_hit"] == before["any_hit"] + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(occ, di.any_hit_plain(rays, tris))
    assert torch.equal(occ, want[3] >= 0)


def test_many_chunks_of_triangles(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    tris = torch.cat(
        [torch.rand((700, 3), generator=g, device=dev) * 2 - 1,
         torch.randn((700, 6), generator=g, device=dev) * 0.2], dim=1,
    )
    tris[400:450] = tris[0:50]  # duplicates in a later chunk lose ties
    rays = _rays(3000, dev, seed=4)
    got = di.closest(rays, tris.contiguous())
    want = di.closest_plain(rays, tris)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_trace_paths_launches_once_per_query(dev):
    sc = cornell_box(16, 16)
    scene = sc.compile().to(dev)
    cfg = PathConfig(spp=1, max_depth=3)
    n = 16 * 16
    px = torch.arange(n, device=dev)
    di.reset_launches()
    li = trace_paths(scene, sc.camera, cfg, 0, torch.zeros_like(px), px)
    torch.cuda.synchronize()
    assert di.LAUNCHES == {"closest": 1 + cfg.max_depth, "any_hit": 0}
    assert bool(torch.isfinite(li).all())


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    tris = cornell_box(8, 8).compile().to(dev).prim_table
    rays = _rays(64, dev)
    with pytest.raises(ValueError):
        di.closest(rays[:, ::2], tris)  # not contiguous
    with pytest.raises(ValueError):
        di.closest(rays, tris.cpu())  # devices differ
