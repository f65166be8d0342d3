"""Masked piecewise polynomial detrending (the reference's
utils/mydetrend.py).

Port of ``pypulsar_tpu/utils/detrend.py``. The host helpers ``detrend``,
``old_detrend`` and ``fit_poly`` are numpy and scipy, as there.
:func:`detrend_blocks` fits a stack of blocks at once on the device: one
batched weighted least squares, omitted cells of weight zero in the
normal equations, in float32 as the JAX package solves it.
"""

import numpy as np
import scipy.linalg
import torch

from pypulsar_tpu_torch.core.device import resolve_device


def old_detrend(ydata, xdata=None, mask=None, order=1):
    """Detrend with an explicit boolean omit-mask (True = omit from the
    fit; the reference's utils/mydetrend.py:19-62)."""
    if xdata is None:
        xdata = np.arange(ydata.size)
    powers = np.arange(order + 1)
    A = np.repeat(xdata, order + 1).reshape(xdata.size, order + 1) ** powers

    if mask is None:
        unmasked = np.ones(ydata.size, dtype="bool")
    else:
        unmasked = ~np.asarray(mask, dtype=bool)
    coeffs, _resids, _rank, _s = scipy.linalg.lstsq(A[unmasked],
                                                    ydata[unmasked])
    return ydata - np.dot(A, coeffs)


def detrend(ydata, xdata=None, order=1, bp=None, numpieces=None):
    """Piecewise polynomial detrend of a (possibly masked) 1-D array.

    ``bp`` lists the indices where new independently detrended segments
    start (len(bp) + 1 segments); ``numpieces`` splits into roughly equal
    parts instead and overrides ``bp``. Masked input gives masked output
    (the reference's utils/mydetrend.py:65-107)."""
    ymasked = np.ma.masked_array(ydata, mask=np.ma.getmaskarray(ydata))
    if xdata is None:
        xdata = np.ma.masked_array(
            np.arange(ydata.size), mask=np.ma.getmaskarray(ydata))
    detrended = ymasked.copy()

    if numpieces is None:
        edges = [0] + list(bp if bp is not None else []) + [len(ydata)]
    else:
        edges = np.round(np.linspace(0, len(ydata), numpieces + 1,
                                     endpoint=1)).astype(int)
    for start, stop in zip(edges[:-1], edges[1:]):
        if not np.ma.count(ymasked[start:stop]):
            continue  # a fully masked segment stays masked in the output
        _coeffs, poly_ydata = fit_poly(ymasked[start:stop],
                                       xdata[start:stop], order)
        detrended.data[start:stop] -= poly_ydata
    if np.ma.isMaskedArray(ydata):
        return detrended
    return detrended.data


def fit_poly(ydata, xdata, order=1):
    """Least-squares polynomial fit honouring masks. Returns
    (coeffs[order + 1], the polynomial at every x, masked ones too)."""
    xmasked = np.ma.asarray(xdata)
    ymasked = np.ma.asarray(ydata)
    if not np.ma.count(ymasked):
        raise ValueError(
            "Cannot fit polynomial to data. There are no unmasked values!")
    ycomp = ymasked.compressed()
    xcomp = xmasked.compressed()

    powers = np.arange(order + 1)
    A = np.repeat(xcomp, order + 1).reshape(xcomp.size, order + 1) ** powers
    coeffs, _resids, _rank, _s = scipy.linalg.lstsq(A, ycomp)

    Afull = np.repeat(np.asarray(xmasked.data, dtype=float),
                      order + 1).reshape(len(xmasked.data), order + 1) \
        ** powers
    return coeffs, np.dot(Afull, coeffs).squeeze()


def detrend_blocks(y, x, omit, order=1, device="cuda",
                   dtype=torch.float32) -> np.ndarray:
    """Masked polynomial detrend of a stack of blocks on ``device``.

    ``y``/``x``/``omit`` are [B, L]: B independent blocks of L samples
    with per-cell omit masks (True = left out of the fit, detrended in
    the output all the same). ``old_detrend`` of each block, as one
    weighted least-squares batch: omitted and non-finite cells
    get weight 0 in the normal equations ``(A^T W A) c = A^T W y``
    (a ridge of 1e-6 keeps a block with fewer kept cells than
    coefficients solvable), and x is centred and scaled over each
    block's kept cells so the system stays well conditioned. A block
    with no kept cell comes back unchanged. ``dtype`` is the solve's
    precision: float32 by default, as the JAX package solves it;
    ``torch.float64`` gives the reference's host ``lstsq`` precision,
    where a card and a CPU agree to rounding (autozap's choice). Returns
    [B, L] of ``dtype``."""
    device = resolve_device(device)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def on(a, kind):
        return torch.as_tensor(np.asarray(a, dtype=kind), device=device)

    y, x = on(y, np_dtype), on(x, np_dtype)
    keep = ~on(omit, bool)
    # zero weight alone is no exclusion: 0 * (-inf or NaN) is NaN, so
    # non-finite cells leave the fit and keep their values in y - fit
    finite = torch.isfinite(y) & torch.isfinite(x)
    w = (keep & finite).to(y.dtype)
    zero = torch.zeros((), dtype=y.dtype, device=device)
    y_fit = torch.where(finite, y, zero)
    x_fit = torch.where(finite, x, zero)
    n = w.sum(dim=1, keepdim=True).clamp_min(1.0)
    xc = (x_fit * w).sum(dim=1, keepdim=True) / n
    xs = torch.sqrt((w * (x_fit - xc) ** 2).sum(dim=1, keepdim=True) / n)
    xs = xs.clamp_min(1e-12)
    powers = torch.arange(order + 1, device=device, dtype=y.dtype)
    A = ((x_fit - xc) / xs)[:, :, None] ** powers  # [B, L, k]
    Aw = A * w[:, :, None]
    M = torch.einsum("bli,blj->bij", Aw, A)
    r = torch.einsum("bli,bl->bi", Aw, y_fit)
    M = M + 1e-6 * torch.eye(order + 1, device=device, dtype=y.dtype)
    c = torch.linalg.solve(M, r[..., None])[..., 0]  # [B, k]
    # the polynomial at the true (finite) x positions
    fit = torch.einsum("bli,bi->bl", ((x - xc) / xs)[:, :, None] ** powers,
                       c)
    any_kept = (w > 0).any(dim=1, keepdim=True)
    return torch.where(any_kept, y - fit, y).cpu().numpy()
