"""Quick-look plotting helpers (matplotlib analogue of the reference's Makie
extension, ext/JustRelaxMakieExt.jl: heatmaps of T/η/τII/velocity and
convergence curves, rendered headlessly).

Counterpart of ``justrelax_tpu/utils/plotting.py``; for the same inputs the
images are pixel for pixel the JAX package's. Fields are tensors (on any
device, copied to the host once) or arrays. matplotlib is imported inside
each call (the Agg backend), so a run that plots nothing never imports it,
and a missing matplotlib raises there.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from justrelax_tpu_torch.core.device import host

Array = Any

__all__ = ["heatmap", "multipanel", "convergence_plot", "velocity_quiver"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _extent(geometry):
    ox, oy = geometry.origin
    lx, ly = geometry.li
    return (ox, ox + lx, oy, oy + ly)


def _save(plt, fig, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def heatmap(A, geometry, path: str, title: str = "", cmap: str = "viridis",
            log: bool = False) -> str:
    """Single cell-centered field → png (imshow in physical coordinates)."""
    plt = _mpl()
    A = host(A)
    if log:
        A = np.log10(np.abs(A) + 1e-300)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(A.T, origin="lower", extent=_extent(geometry), aspect="auto",
                   cmap=cmap)
    fig.colorbar(im, ax=ax)
    ax.set(title=title, xlabel="x", ylabel="y")
    return _save(plt, fig, path)


def multipanel(fields: Dict[str, Array], geometry, path: str,
               ncols: int = 2) -> str:
    """The miniapps' standard 2×2-style diagnostic figure (T, η, τII, V…)."""
    plt = _mpl()
    n = len(fields)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(5.5 * ncols, 4.5 * nrows),
                             squeeze=False)
    for ax, (name, A) in zip(axes.ravel(), fields.items()):
        im = ax.imshow(host(A).T, origin="lower", extent=_extent(geometry),
                       aspect="auto")
        fig.colorbar(im, ax=ax)
        ax.set_title(name)
    for ax in axes.ravel()[n:]:
        ax.axis("off")
    return _save(plt, fig, path)


def convergence_plot(err_history: Sequence[float], path: str,
                     eps: Optional[float] = None, nout: int = 1) -> str:
    """Residual-vs-iteration curve (the reference's per-solve convergence
    figure). NaN-padded entries (unused chunks) are dropped."""
    plt = _mpl()
    e = host(err_history).astype(float)
    e = e[np.isfinite(e)]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(np.arange(1, e.size + 1) * nout, e, marker="o", ms=3)
    if eps is not None:
        ax.axhline(eps, color="r", ls="--", lw=1, label=f"eps = {eps:g}")
        ax.legend()
    ax.set(xlabel="PT iteration", ylabel="max residual norm")
    return _save(plt, fig, path)


def velocity_quiver(Vx_c, Vy_c, geometry, path: str, stride: int = 4,
                    background: Optional[Array] = None) -> str:
    """Velocity arrows (optionally over a background field)."""
    plt = _mpl()
    Vx_c, Vy_c = host(Vx_c), host(Vy_c)
    x = np.asarray(geometry.xci[0])
    y = np.asarray(geometry.xci[1])
    X, Y = np.meshgrid(x, y, indexing="ij")
    fig, ax = plt.subplots(figsize=(6, 5))
    if background is not None:
        im = ax.imshow(host(background).T, origin="lower",
                       extent=_extent(geometry), aspect="auto")
        fig.colorbar(im, ax=ax)
    s = slice(None, None, stride)
    ax.quiver(X[s, s], Y[s, s], Vx_c[s, s], Vy_c[s, s], color="k", width=2e-3)
    ax.set(xlabel="x", ylabel="y")
    return _save(plt, fig, path)
