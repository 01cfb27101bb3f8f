"""OBJ import CLI (``akari_tpu/cli/importer.py``): OBJ -> binary mesh cache
+ a generated ``.akari`` SDL module with the translated materials.

Usage: python -m akari_torch.cli.importer model.obj [-o outdir]

Writes ``<name>.mesh.npz`` (``scene/meshcache.py``, readable by either
package) and ``<name>.akari``, which exports ``mesh`` (an ``AkariMesh``
over the cache) for scene files to import.
"""

from __future__ import annotations

import argparse
import os
import re
import sys


def _mat_to_sdl(name, mat, outdir="."):
    """Material node -> SDL export statement text.

    Image textures round-trip by path: relative to the generated .akari's
    directory when the image lies under it (the SDL resolves string
    paths against that directory), absolute otherwise. A Mix is flattened
    one level: its two materials become let-bindings.
    """
    from ..scene.nodes import (
        ConstantTexture,
        EmissiveMaterial,
        GlassMaterial,
        GlossyMaterial,
        ImageTexture,
        MirrorMaterial,
        MixMaterial,
    )

    def tex(t):
        t = ConstantTexture.coerce(t) if not isinstance(t, ImageTexture) else t
        if isinstance(t, ImageTexture):
            p = t.path or "<image>"
            rel = os.path.relpath(p, outdir)
            if not rel.startswith(".."):
                p = rel
            return '"' + p.replace("\\", "/") + '"'
        v = t.value
        return f"[{v[0]:g},{v[1]:g},{v[2]:g}]"

    if isinstance(mat, EmissiveMaterial):
        body = f"EmissiveMaterial {{\n  color : {tex(mat.color)}\n}}"
    elif isinstance(mat, GlossyMaterial):
        body = (
            f"GlossyMaterial {{\n  color : {tex(mat.color)},\n"
            f"  roughness: {tex(mat.roughness)}\n}}"
        )
    elif isinstance(mat, MixMaterial):
        return (
            f"let {name}_A = {_inline(mat.material_a, outdir)}\n"
            f"let {name}_B = {_inline(mat.material_b, outdir)}\n"
            f"export {name} = MixMaterial {{\n  fraction: {tex(mat.fraction)},\n"
            f"  material_A: ${name}_A,\n  material_B: ${name}_B\n}}"
        )
    elif isinstance(mat, GlassMaterial):
        body = (
            f"GlassMaterial {{\n  color : {tex(mat.color)},\n"
            f"  ior: {mat.ior:g}\n}}"
        )
    elif isinstance(mat, MirrorMaterial):
        body = f"MirrorMaterial {{\n  color : {tex(mat.color)}\n}}"
    else:
        body = f"DiffuseMaterial {{\n  color : {tex(mat.color)}\n}}"
    return f"export {name} = {body}"


def _inline(mat, outdir="."):
    lines = _mat_to_sdl("_x", mat, outdir)
    return lines.split("= ", 1)[1]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="akari-import-torch")
    ap.add_argument("input", help="OBJ file")
    ap.add_argument("-o", "--outdir", default=None)
    args = ap.parse_args(argv)

    from ..scene import meshcache
    from ..scene.obj import load_obj
    from ..utils.logger import get_logger

    log = get_logger()
    mesh = load_obj(args.input)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    name = re.sub(r"[^A-Za-z0-9_]", "_", stem)
    outdir = args.outdir or os.path.dirname(os.path.abspath(args.input))
    os.makedirs(outdir, exist_ok=True)

    mesh_path = os.path.join(outdir, name + ".mesh.npz")
    meshcache.save_mesh(mesh_path, mesh)
    log.info(f"wrote {mesh_path} ({len(mesh.indices)} tris)")

    sdl_lines = []
    mat_names = []
    for i, m in enumerate(mesh.materials):
        mname = f"{name}_mat{i}"
        mat_names.append(mname)
        sdl_lines.append(_mat_to_sdl(mname, m, outdir))
        sdl_lines.append("")
    mats_list = ",\n    ".join(f"${n}" for n in mat_names)
    sdl_lines.append(
        f"export mesh = AkariMesh {{\n  path: \"{name}.mesh.npz\",\n"
        f"  materials: [\n    {mats_list}\n  ]\n}}"
    )
    akari_path = os.path.join(outdir, name + ".akari")
    with open(akari_path, "w") as f:
        f.write("\n".join(sdl_lines) + "\n")
    log.info(f"wrote {akari_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
