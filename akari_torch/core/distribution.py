"""1D sampling distributions as CDF arrays (``akari_tpu/core/distribution.py``).

The CDF is built on the host at scene-compile time (NumPy, float64 sums
cast to float32) and sampled on the device with ``torch.searchsorted``.
"""

from __future__ import annotations

import numpy as np
import torch


def build_cdf(weights):
    """Host-side. Returns (pdf, cdf) with cdf shape [n+1], cdf[-1] == 1.

    Degenerate all-zero weights become uniform.
    """
    w = np.asarray(weights, dtype=np.float64)
    n = w.shape[0]
    total = w.sum()
    if total <= 0.0:
        pdf = np.full(n, 1.0 / n)
    else:
        pdf = w / total
    cdf = np.concatenate([[0.0], np.cumsum(pdf)])
    cdf[-1] = 1.0
    return pdf.astype(np.float32), cdf.astype(np.float32)


def sample_discrete(cdf, u):
    """Device-side. u in [0,1) -> (int32 index, pdf). cdf is the [n+1] tensor."""
    idx = torch.clamp(
        torch.searchsorted(cdf, u, right=True) - 1, 0, cdf.shape[0] - 2
    )
    pdf = cdf[idx + 1] - cdf[idx]
    return idx.to(torch.int32), pdf


def sample_continuous(cdf, u):
    """Piecewise-constant continuous sampling over [0, 1): u in [0, 1) ->
    (x, pdf, int32 index): x linearly interpolated inside the bin picked
    by ``searchsorted(right)``, pdf the continuous density (pmf * n)."""
    n = cdf.shape[0] - 1
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n - 1)
    c0 = cdf[idx]
    pmf = cdf[idx + 1] - c0
    du = torch.where(pmf > 0.0, (u - c0) / torch.where(pmf > 0.0, pmf, 1.0), 0.0)
    x = (idx.to(cdf.dtype) + du) / n
    return x, pmf * n, idx.to(torch.int32)


def pdf_continuous(cdf, x):
    """Continuous density at x in [0, 1): pmf[floor(x * n)] * n."""
    n = cdf.shape[0] - 1
    idx = torch.clamp((x * n).to(torch.int32), 0, n - 1).to(torch.int64)
    return (cdf[idx + 1] - cdf[idx]) * n
