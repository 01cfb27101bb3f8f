"""Texture evaluation: constant and image textures, batched over lanes
(``akari_tpu/shading/texture.py``).

Images are bilinearly filtered with wrap-repeat and V flipped (image row
0 is v = 1). The kind dispatch is a per-lane select; both branches are
gathers.
"""

from __future__ import annotations

import torch

from ..scene.arrays import TEX_IMAGE


def _bilinear(images, image_sizes, img_id, uv):
    """Sample stacked padded images [I, Hm, Wm, 3] at uv [N, 2] with wrap
    repeat -> [N, 3]. ``%`` on floats and ints follows Python's sign rule
    (``torch.remainder``), as the reference's ``%`` / ``mod`` do."""
    h = image_sizes[:, 0].index_select(0, img_id).to(torch.float32)
    w = image_sizes[:, 1].index_select(0, img_id).to(torch.float32)
    u = uv[..., 0] % 1.0
    v = (-uv[..., 1]) % 1.0
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    hi = image_sizes[:, 0].index_select(0, img_id).to(torch.int64)
    wi = image_sizes[:, 1].index_select(0, img_id).to(torch.int64)
    flat = images.reshape(-1, 3)
    stride_img = images.shape[1] * images.shape[2]
    base = img_id.to(torch.int64) * stride_img

    def fetch(xi, yi):
        xi = torch.remainder(xi.to(torch.int32).to(torch.int64), wi)
        yi = torch.remainder(yi.to(torch.int32).to(torch.int64), hi)
        return flat.index_select(0, base + yi * images.shape[2] + xi)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def evaluate(textures, tex_id, uv):
    """(TextureTable, [N] ids, [N, 2] uv) -> [N, 3] rgb."""
    kind = textures.kind.index_select(0, tex_id)
    base = textures.value.index_select(0, tex_id)
    img_id = textures.image_id.index_select(0, tex_id)
    img_rgb = _bilinear(textures.images, textures.image_sizes, img_id, uv)
    return torch.where((kind == TEX_IMAGE)[..., None], base * img_rgb, base)


def evaluate_scalar(textures, tex_id, uv):
    """First channel only (roughness / mix fraction)."""
    return evaluate(textures, tex_id, uv)[..., 0]
