"""Transition-path plotting, the reference driver's plot step (port of
`hank_tpu/utils/plotting.py`, `RunMain.jl:57-60`).

`plot_transition` writes a small-multiples PNG of every endogenous path
(plus steady-state reference lines), and `plot_distribution` renders the
household-distribution evolution from `blocks.forward.distribution_path`
(the marginal over the first endogenous axis as a time × grid heatmap).
Both take numpy arrays or torch tensors on any device.

matplotlib is optional: it is imported only when a plot is asked for
(headless Agg backend: files, no display).
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def plot_transition(x_path, endog_names, out_path: str,
                    ss_initial=None, ss_ending=None, title: str | None = None):
    """Small-multiples plot of each endogenous variable's transition path.

    x_path: (T-1, n_endog) solved path (period-major, `run.solve_model`
    output). ss_initial / ss_ending: optional SteadyState (or vars mapping)
    drawn as dashed start/end reference lines. Returns out_path.
    """
    plt = _mpl()
    x_path = _np(x_path)
    n = len(endog_names)
    ncols = min(n, 2)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(5.5 * ncols, 3 * nrows),
                             squeeze=False)
    t = np.arange(1, x_path.shape[0] + 1)

    def _vars(ss):
        return getattr(ss, "vars", ss)

    for i, name in enumerate(endog_names):
        ax = axes[i // ncols][i % ncols]
        ax.plot(t, x_path[:, i], lw=1.5)
        for ss, style, label in ((ss_initial, ":", "initial SS"),
                                 (ss_ending, "--", "ending SS")):
            if ss is not None and name in _vars(ss):
                ax.axhline(float(_vars(ss)[name]), ls=style, lw=1.0,
                           color="gray", label=label)
        ax.set_title(name)
        ax.set_xlabel("t")
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if n and (ss_initial is not None or ss_ending is not None):
        axes[0][0].legend(fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_distribution(Ds, grid, out_path: str, every: int = 1,
                      title: str | None = None):
    """Heatmap of the wealth-marginal distribution over time.

    Ds: (T, *state_shape) from `distribution_path`; the first axis of each
    frame is the (endogenous) wealth axis, all other axes are summed out.
    """
    plt = _mpl()
    Ds = _np(Ds)
    marg = Ds.reshape(Ds.shape[0], Ds.shape[1], -1).sum(axis=2)[::every]
    fig, ax = plt.subplots(figsize=(7, 4))
    im = ax.pcolormesh(np.arange(marg.shape[0]) * every, _np(grid),
                       marg.T, shading="auto")
    fig.colorbar(im, ax=ax, label="mass")
    ax.set_xlabel("t")
    ax.set_ylabel("wealth")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
