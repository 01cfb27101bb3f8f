"""Ray coherence sort keys (``akari_tpu/ops/pallas_intersect.py::_sort_keys_soa``).

Key per ray: direction octant (3 bits, major) | direction Morton | origin
Morton, with the reference's bit split per ray population:

- ``primary`` (camera rays, one shared origin): 4 direction bits and 5
  origin bits per axis;
- ``secondary`` (bounce and shadow rays, origins spread over the scene):
  1 direction bit and 8 origin bits per axis.

Dead rays (t_max <= t_min) get the maximal key 0xFFFFFFFF, so they gather
at the end. Keys are the reference's uint32 values, held in int64 (torch's
bitwise ops and sorts are complete for int64). Sorting never changes a
result: each ray's answer is its own; the sort only makes neighbouring
threads walk similar paths through the tree.
"""

from __future__ import annotations

import torch

DEAD_KEY = 0xFFFFFFFF


def sort_keys_soa(o, d, lo, hi, t_min=None, t_max=None, hint="primary"):
    """V3 o/d [N], scene bounds lo/hi [3] float32 -> [N] int64 keys."""
    if hint not in ("primary", "secondary"):
        raise ValueError(f"hint {hint!r}: expected 'primary' or 'secondary'")
    dbits, obits = (1, 8) if hint == "secondary" else (4, 5)
    ext = torch.clamp(hi - lo, min=1e-6)
    m = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    for a, oc in enumerate((o.x, o.y, o.z)):
        q = (
            torch.clamp((oc - lo[a]) / ext[a], 0.0, 1.0) * (2.0 ** obits - 1.0)
        ).to(torch.int64)
        for b in range(obits):
            m = m | (((q >> b) & 1) << (3 * b + a))
    dm = torch.zeros_like(m)
    for a, dc in enumerate((d.x, d.y, d.z)):
        q = (
            torch.clamp(torch.abs(dc), 0.0, 0.99999) * (2.0 ** dbits - 1.0)
        ).to(torch.int64)
        for b in range(dbits):
            dm = dm | (((q >> b) & 1) << (3 * b + a))
    octant = (
        (d.x < 0).to(torch.int64)
        | ((d.y < 0).to(torch.int64) << 1)
        | ((d.z < 0).to(torch.int64) << 2)
    )
    key = (octant << (3 * (dbits + obits))) | (dm << (3 * obits)) | m
    if t_min is not None and t_max is not None:
        key = torch.where(t_max <= t_min, DEAD_KEY, key)
    return key
