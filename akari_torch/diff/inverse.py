"""Inverse rendering: recover scene parameters from a target image
(``akari_tpu/diff/inverse.py``).

The optimizable leaves are ``TextureTable.value`` (constant colors: albedo
and emitter radiance, and the multipliers of image textures),
``TextureTable.images`` (``tex_images``, the image texels) and, on flat
scenes, ``tri_delta``, a per-triangle world-space translation. Gradients
run through the renderer under the detached-hit convention
(integrators/path.py); a texel's gradient is the scatter-add
(``index_add``) of the four ``index_select`` fetches of
``shading/texture.py::_bilinear``, so padding texels get none. With a ray
mesh the loss is ``loss_and_image_sharded``, whose backward sums the
gradients over the ranks.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..parallel.render import check_device, loss_and_image, loss_and_image_sharded

LOG_MIN, LOG_MAX = math.log(1e-4), math.log(1e4)


@dataclass(frozen=True)
class InverseConfig:
    iterations: int = 100
    learning_rate: float = 5e-2
    optimize_images: bool = False  # also optimize image-texture texels
    seed: int = 0
    # "constant" | "cosine": cosine decays the lr to 5 % over the run
    lr_schedule: str = "constant"
    # ((start_fraction, spp), ...): per-phase spp of the render config;
    # empty = render_cfg.spp throughout
    spp_ramp: tuple = ()
    # EMA of the iterates from half the run on; 0 disables
    param_ema: float = 0.0
    # "linear" | "log": texture values and texels optimized in log space
    # (tri_delta, signed, stays linear)
    param_space: str = "linear"


def _refuse_two_level():
    # on a two-level scene tri_v0 is shared prototype (object) space: one
    # delta would move every instance of it at once
    raise ValueError(
        "optimize_geometry=True requires a flat (non-instanced) scene; "
        "compile with its instances flattened (under FLATTEN_MAX_TRIS)"
    )


def scene_params(scene, optimize_images=False, optimize_geometry=False):
    """The optimizable parameters of a compiled scene as a dict of fresh
    leaf tensors on the scene's device (the caller sets
    ``requires_grad``): ``tex_value`` [X, 3]; with ``optimize_images``,
    ``tex_images`` [I, Hm, Wm, 3], the stacked padded linear texels; with
    ``optimize_geometry``, ``tri_delta`` [T, 3] zeros.

    Through the render alone, ``tri_delta`` gets the interior term; the
    visibility boundary term is ``diff/boundary.py``'s surrogate, added to
    the image inside the loss. The traversal tables are built for the
    undisplaced geometry: re-``compile()`` after large deltas.
    """
    params = {"tex_value": scene.textures.value.detach().clone()}
    if optimize_images:
        params["tex_images"] = scene.textures.images.detach().clone()
    if optimize_geometry:
        if scene.instances is not None:
            _refuse_two_level()
        params["tri_delta"] = torch.zeros_like(scene.tri_v0)
    return params


def apply_params(scene, params):
    """A new ``SceneArrays`` with the parameters written in (functional:
    the scene given is not modified). ``tri_delta`` moves ``tri_v0`` and
    the v0 columns 0:3 of ``prim_table`` (one row per storage triangle);
    the tree tables (``tri_blocks``) stay undisplaced, as the reference's
    do."""
    for k, v in params.items():
        check_device(v, scene.device, f"parameter {k!r}")
    tex = dataclasses.replace(scene.textures, value=params["tex_value"])
    if "tex_images" in params:
        tex = dataclasses.replace(tex, images=params["tex_images"])
    scene = dataclasses.replace(scene, textures=tex)
    if "tri_delta" in params:
        if scene.instances is not None:
            _refuse_two_level()
        d = params["tri_delta"]
        repl = {"tri_v0": scene.tri_v0 + d}
        if scene.prim_table is not None:
            pt = scene.prim_table
            repl["prim_table"] = torch.cat([pt[:, 0:3] + d, pt[:, 3:]], dim=1)
        scene = dataclasses.replace(scene, **repl)
    return scene


def cosine_lr(lr, step, total, alpha=0.05):
    """``optax.cosine_decay_schedule(lr, total, alpha)`` at ``step``
    updates done, in closed form."""
    frac = min(step, total) / total
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)


def inverse_render(scene, camera, render_cfg, target, cfg=None, mesh=None):
    """Adam loop fitting the texture values (and, with
    ``cfg.optimize_images``, the texels) to ``target`` [H, W, 3] on the
    scene's device. Returns (recovered_scene, losses, final_image); each
    iteration renders with seed ``cfg.seed + it``, and the final image is
    the last iteration's render.

    With ``mesh`` (a ``RayMesh``; every rank calls this with the same
    arguments) each iteration's loss is ``loss_and_image_sharded``: the
    gradients are summed over the ranks before their non-finite entries
    are zeroed, as the reference orders it, so every rank takes the same
    Adam step and the parameters stay equal bit for bit.
    """
    cfg = cfg or InverseConfig()
    check_device(target, scene.device, "the target image")
    log_space = cfg.param_space == "log"
    params = scene_params(scene, cfg.optimize_images)
    if log_space:
        params = {k: torch.log(torch.clamp(v, min=1e-4)) for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    keys = list(params)

    def to_raw(p):
        return {k: torch.exp(v) for k, v in p.items()} if log_space else p

    # optax.adam's defaults
    opt = torch.optim.Adam(list(params.values()), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    phases = [(0, render_cfg)] + [
        (int(frac * cfg.iterations), dataclasses.replace(render_cfg, spp=int(spp)))
        for frac, spp in cfg.spp_ramp
    ]
    phases.sort(key=lambda x: x[0])
    ema = None
    ema_start = cfg.iterations // 2
    losses, img = [], None
    for it in range(cfg.iterations):
        rc = next(c for start, c in reversed(phases) if it >= start)
        if cfg.lr_schedule == "cosine":
            opt.param_groups[0]["lr"] = cosine_lr(cfg.learning_rate, it, cfg.iterations)
        fitted = apply_params(scene, to_raw(params))
        if mesh is None:
            loss, img = loss_and_image(fitted, camera, rc, target, seed=cfg.seed + it)
        else:
            loss, img = loss_and_image_sharded(fitted, camera, rc, mesh, target,
                                               seed=cfg.seed + it)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        for k, g in zip(keys, grads):
            # MC gradients can hold stray non-finite lanes (the glass and
            # Fresnel branches at sqrt'(0)): zero them, as the reference
            # does, rather than poison the Adam moments
            params[k].grad = torch.where(torch.isfinite(g), g, 0.0)
        opt.step()
        with torch.no_grad():
            for v in params.values():  # texture values are non-negative
                if log_space:
                    v.clamp_(LOG_MIN, LOG_MAX)
                else:
                    v.clamp_(min=1e-4)
            if cfg.param_ema > 0.0 and it >= ema_start:
                d = cfg.param_ema
                ema = ({k: v.clone() for k, v in params.items()} if ema is None
                       else {k: ema[k] * d + v * (1.0 - d) for k, v in params.items()})
        losses.append(float(loss.detach()))
        img = img.detach()
    final = ema if ema is not None else {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        return apply_params(scene, to_raw(final)), losses, img
