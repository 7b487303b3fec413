"""Plot engine: pileup heatmap grids and stripe stack-ups.

Counterpart of reference plotpup.py (plot :672, plot_stripes :290,
get_min_max :49, add_heatmap :115, add_score :264) with the same public
surface and visual semantics — log-symmetric color normalization around 1,
faceting by any metadata columns (auto orientation x separation), NaN pixels
in a dedicated color, per-panel score labels, one shared colorbar — built on
plain matplotlib. Counterpart of ``coolpuppy_tpu/plotting.py``: the same
functions over the port's ``lib`` (the only module of the port, with
``cli/plotpup_cli.py``, that imports matplotlib)."""

from __future__ import annotations

import logging
import warnings

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
from matplotlib import cm, ticker
from matplotlib.colors import LogNorm, Normalize

from .genomics.intervals import natsort_key
from .lib import numutils
from .lib.puputils import get_score

logger = logging.getLogger("coolpuppy_tpu_torch")


def auto_rows_cols(n):
    """Rows/cols to lay out n pileups (reference plotpup.py:28–45)."""
    rows = int(np.ceil(np.sqrt(n)))
    cols = int(np.ceil(n / rows))
    return rows, cols


def sort_separation(sep_string_series, sep="Mb"):
    s = set(pd.Series(sep_string_series).dropna())
    s.discard("all")
    return sorted(s, key=lambda x: float(str(x).split(sep)[0]))


def get_min_max(pups, vmin=None, vmax=None, sym=True, scale="log"):
    """Color range selection, symmetric around 1 in log scale
    (reference plotpup.py:49–112)."""
    if vmin is not None and vmax is not None:
        if sym:
            logger.info(
                "Can't set both vmin and vmax and get symmetrical scale. "
                "Plotting non-symmetrical"
            )
        return vmin, vmax
    comb = np.concatenate([np.asarray(pup).ravel() for pup in np.ravel(pups)])
    comb = comb[np.isfinite(comb)]
    comb = comb[comb != 0]
    if comb.size == 0 or np.isnan(comb).all():
        raise ValueError("Data only contains NaNs or zeros")
    if vmin is None and vmax is None:
        vmax = np.nanmax(comb)
        vmin = np.nanmin(comb)
    elif vmin is not None:
        vmax = 1 if (sym and scale == "log") else np.nanmax(comb)
    elif vmax is not None:
        vmin = 1 if (sym and scale == "log") else np.nanmin(comb)
    if sym:
        if scale == "linear":
            logger.info(
                "Can't use symmetrical scale with linear. Plotting "
                "non-symmetrical"
            )
        else:
            vmax = 2 ** (np.max(np.abs(np.log2([vmin, vmax]))))
            if vmax >= 1:
                vmin = 2 ** -np.log2(vmax)
            else:
                raise ValueError(
                    "Maximum value is less than 1.0, can't plot using "
                    "symmetrical scale"
                )
    return vmin, vmax


def _facet_orders(pupsdf, cols, rows, col_order, row_order):
    """Resolve facet columns/orders, defaulting to orientation x separation
    (reference plotpup.py:707–743)."""
    if cols == "separation" and col_order is None:
        col_order = sort_separation(pupsdf["separation"])
    elif cols is not None and col_order is None:
        col_order = sorted(set(pupsdf[cols].dropna()), key=natsort_key)
    if rows == "separation" and row_order is None:
        row_order = sort_separation(pupsdf["separation"])
    elif rows is not None and row_order is None:
        row_order = sorted(set(pupsdf[rows].dropna()), key=natsort_key)
    if cols is None and rows is None and pupsdf.shape[0] > 1:
        if "orientation" in pupsdf.columns:
            rows = "orientation"
            row_order = sorted(set(pupsdf[rows].dropna()), key=natsort_key)
        if "separation" in pupsdf.columns:
            cols = "separation"
            col_order = sort_separation(pupsdf["separation"])
    if isinstance(col_order, str):
        col_order = [col_order]
    if isinstance(row_order, str):
        row_order = [row_order]
    return cols, rows, col_order or [None], row_order or [None]


def _select(pupsdf, cols, rows, cval, rval):
    sel = pupsdf
    if cols is not None and cval is not None:
        sel = sel[sel[cols] == cval]
    if rows is not None and rval is not None:
        sel = sel[sel[rows] == rval]
    return sel


def _cbar_ticks(norm, sym, scale):
    if sym and scale == "log":
        return [norm.vmin, 1, norm.vmax]
    return [norm.vmin, norm.vmax]


def _shared_colorbar(fig, axes, norm, cmap, sym, scale):
    pos_tr = axes[0][-1].get_position()
    pos_br = axes[-1][-1].get_position()
    cax = fig.add_axes(
        [pos_tr.x1 + 0.02, pos_br.y0, 0.02, pos_tr.y1 - pos_br.y0]
    )
    fig.colorbar(
        cm.ScalarMappable(norm, cmap),
        ticks=_cbar_ticks(norm, sym, scale),
        cax=cax,
        format=ticker.FuncFormatter(lambda x, pos: f"{x:.2g}"),
    )
    cax.minorticks_off()
    return cax


def _add_colorbars(fig, axes, norm, cmap, sym, scale, cbar_mode):
    """Colorbar placement: 'single' (one shared, the default), 'edge' (one
    per heatmap row), or 'each' (one per panel)."""
    mappable = cm.ScalarMappable(norm, cmap)
    fmt = ticker.FuncFormatter(lambda x, pos: f"{x:.2g}")
    ticks = _cbar_ticks(norm, sym, scale)
    if cbar_mode == "single":
        return _shared_colorbar(fig, axes, norm, cmap, sym, scale)
    if cbar_mode == "edge":
        for row_axes in axes:
            pos = row_axes[-1].get_position()
            cax = fig.add_axes([pos.x1 + 0.02, pos.y0, 0.02, pos.y1 - pos.y0])
            fig.colorbar(mappable, ticks=ticks, cax=cax, format=fmt)
            cax.minorticks_off()
        return None
    if cbar_mode == "each":
        for row_axes in axes:
            for ax in row_axes:
                if not ax.get_visible() or not ax.has_data():
                    continue
                pos = ax.get_position()
                cax = fig.add_axes(
                    [pos.x1 + 0.005, pos.y0, 0.012, pos.y1 - pos.y0]
                )
                fig.colorbar(mappable, ticks=ticks, cax=cax, format=fmt)
                cax.minorticks_off()
                cax.tick_params(labelsize=6)
        return None
    raise ValueError("cbar_mode can only be 'single', 'edge' or 'each'")


def _wrap_layout(pupsdf, cols, rows, col_order, row_order, n_cols, n_rows):
    """Optional manual grid layout: when n_cols/n_rows is given and at most
    one facet dimension is in play, wrap the panels into an n_rows x n_cols
    grid (0 = derive; neither set on a facet-less frame = as-square-as-
    possible). Returns (panel_grid, panel_labels) with pupsdf indices, or
    None when the regular cross-product layout applies."""
    if not (n_cols or n_rows):
        return None
    if cols is not None and rows is not None:
        return None  # two real facet dimensions: the cross product stands
    if cols is not None:
        keys = [(c, None) for c in col_order]
        labels = list(col_order)
    elif rows is not None:
        keys = [(None, r) for r in row_order]
        labels = list(row_order)
    else:
        keys = [("__index__", i) for i in range(len(pupsdf))]
        labels = [None] * len(pupsdf)
    n = len(keys)
    if n_cols and n_rows:
        R, C = int(n_rows), int(n_cols)
    elif n_cols:
        C = int(n_cols)
        R = int(np.ceil(n / C))
    else:
        R = int(n_rows)
        C = int(np.ceil(n / R))
    grid, glabels = [], []
    for r in range(R):
        grid.append(
            [keys[r * C + c] if r * C + c < n else None for c in range(C)]
        )
        glabels.append(
            [labels[r * C + c] if r * C + c < n else None for c in range(C)]
        )
    return grid, glabels


def plot(
    pupsdf,
    cols=None,
    rows=None,
    score="score",
    center=3,
    ignore_central=3,
    col_order=None,
    row_order=None,
    vmin=None,
    vmax=None,
    sym=True,
    norm_corners=0,
    cmap="coolwarm",
    cmap_emptypixel=(0.98, 0.98, 0.98),
    scale="log",
    height=1.5,
    aspect=1,
    font_scale=1,
    plot_ticks=False,
    colnames=None,
    rownames=None,
    cbar_mode="single",
    n_cols=0,
    n_rows=0,
    **kwargs,
):
    """Grid of pileup heatmaps (reference plotpup.py:672–941), plus manual
    n_cols/n_rows grid wrapping and cbar_mode single/edge/each."""
    pupsdf = pupsdf.copy().reset_index(drop=True)
    if norm_corners:
        pupsdf["data"] = pupsdf.apply(
            lambda x: numutils.norm_cis(x["data"], norm_corners), axis=1
        )
    cols, rows, col_order, row_order = _facet_orders(
        pupsdf, cols, rows, col_order, row_order
    )
    wrapped = _wrap_layout(
        pupsdf, cols, rows, col_order, row_order, n_cols, n_rows
    )
    if wrapped is not None:
        panel_grid, panel_labels = wrapped
        nrows, ncols = len(panel_grid), len(panel_grid[0])
    else:
        panel_grid = [[(c, r) for c in col_order] for r in row_order]
        panel_labels = None
        ncols, nrows = len(col_order), len(row_order)
    vmin, vmax = get_min_max(pupsdf["data"].values, vmin, vmax, sym, scale)
    norm_cls = {"log": LogNorm, "linear": Normalize}.get(scale)
    if norm_cls is None:
        raise ValueError(f"Unknown scale value {scale}")
    norm = norm_cls(vmin, vmax)
    cmap = plt.get_cmap(cmap).copy()
    cmap.set_bad(cmap_emptypixel)

    if score is True:
        score = "score"
    if score and score not in pupsdf.columns:
        pupsdf[score] = pupsdf.apply(
            get_score, center=center, ignore_central=ignore_central, axis=1
        )

    fig, axarr = plt.subplots(
        nrows,
        ncols,
        figsize=(height * ncols * 1.05 + 0.7, height * nrows * 1.05),
        squeeze=False,
    )
    fontsize = font_scale * (4.94 + height) * 2
    for ri in range(nrows):
        for ci in range(ncols):
            ax = axarr[ri][ci]
            key = panel_grid[ri][ci]
            if key is None:
                ax.axis("off")
                continue
            cval, rval = key
            if cval == "__index__":
                sel = pupsdf.iloc[[rval]]
                cval = rval = None
            else:
                sel = _select(pupsdf, cols, rows, cval, rval)
            if len(sel) > 1:
                raise ValueError(
                    "Multiple pileups for one of the conditions, ensure "
                    "unique correspondence for each col/row combination"
                )
            if len(sel) == 0:
                ax.axis("off")
                continue
            row = sel.iloc[0]
            flank = int(row["flank"]) if not row["rescale"] else 1
            ext = flank / 1000
            ax.imshow(
                row["data"],
                cmap=cmap,
                norm=norm,
                aspect=aspect,
                interpolation="none",
                extent=[-ext, ext, -ext, ext],
            )
            if score and pd.notna(row.get(score, np.nan)):
                ax.text(
                    s=f"{row[score]:.3g}",
                    y=0.95,
                    x=0.05,
                    ha="left",
                    va="top",
                    size=fontsize,
                    transform=ax.transAxes,
                )
            if plot_ticks and not row["rescale"]:
                ax.tick_params(axis="both", labelsize=fontsize * 0.7)
                if ri != nrows - 1:
                    ax.set_xticks([])
                if ci != 0:
                    ax.set_yticks([])
            else:
                ax.set_xticks([])
                ax.set_yticks([])
            if panel_labels is not None:
                if panel_labels[ri][ci] is not None:
                    ax.set_xlabel(str(panel_labels[ri][ci]), fontsize=fontsize)
            else:
                if ri == nrows - 1 and cval is not None:
                    label = colnames[ci] if colnames else cval
                    ax.set_xlabel(label, fontsize=fontsize)
                if ci == 0 and rval is not None:
                    label = rownames[ri] if rownames else rval
                    ax.set_ylabel(
                        label, rotation=0, ha="right", va="center",
                        fontsize=fontsize,
                    )
    fig.subplots_adjust(wspace=0.05, hspace=0.05, right=ncols / (ncols + 0.25))
    _add_colorbars(fig, axarr, norm, cmap, sym, scale, cbar_mode)
    return fig


def make_corner_stripes(pupsdf):
    """Synthesize corner stripes: left half horizontal, right half vertical
    (reference plotpup.py:374–384)."""
    pupsdf = pupsdf.copy()
    cntr = int(np.floor(np.asarray(pupsdf["data"].iloc[0]).shape[0] / 2))
    corner = []
    for i in range(len(pupsdf)):
        h = np.asarray(pupsdf["horizontal_stripe"].iloc[i])
        v = np.asarray(pupsdf["vertical_stripe"].iloc[i])
        corner.append(np.concatenate((h[:, :cntr], v[:, cntr:]), axis=1))
    pupsdf["corner_stripe"] = corner
    return pupsdf


def sort_stripes(pupsdf, stripe, stripe_sort="sum", out_sorted_bedpe=None):
    """Sort stripe rows consistently across conditions (reference
    plotpup.py:386–452): natural-sort by coordinates first, then by row sum
    or center pixel of the first condition."""
    pupsdf = pupsdf.copy().reset_index(drop=True)
    stripe_cols = [
        "coordinates",
        "corner_stripe",
        "vertical_stripe",
        "horizontal_stripe",
    ]
    stripe_cols = [c for c in stripe_cols if c in pupsdf.columns]
    for i in range(len(pupsdf)):
        coords = np.array(
            [".".join(c) for c in pupsdf["coordinates"].iloc[i]], dtype=object
        )
        order = np.array(
            sorted(range(len(coords)), key=lambda k: natsort_key(coords[k])),
            dtype=np.int64,
        )
        for c in stripe_cols:
            pupsdf.at[i, c] = np.asarray(pupsdf[c].iloc[i])[order]
    ref_coords = np.asarray(pupsdf["coordinates"].iloc[0])
    for i in range(1, len(pupsdf)):
        if not np.array_equal(ref_coords, np.asarray(pupsdf["coordinates"].iloc[i])):
            warnings.warn(
                "Cannot sort stripes, rows or columns contain different "
                "regions. Plot one by one if you want to sort",
                stacklevel=2,
            )
            return pupsdf
    base = np.asarray(pupsdf[stripe].iloc[0])
    if stripe_sort == "sum":
        ind_sort = np.argsort(-np.nansum(base, axis=1))
    elif stripe_sort == "center_pixel":
        cntr = int(np.floor(base.shape[1] / 2))
        ind_sort = np.argsort(-base[:, cntr])
    else:
        raise ValueError("stripe_sort can only be None, sum, or center_pixel")
    for i in range(len(pupsdf)):
        for c in stripe_cols:
            pupsdf.at[i, c] = np.asarray(pupsdf[c].iloc[i])[ind_sort]
    if isinstance(out_sorted_bedpe, str):
        pd.DataFrame(list(pupsdf["coordinates"].iloc[0])).to_csv(
            out_sorted_bedpe, sep="\t", header=None, index=False
        )
    return pupsdf


def plot_stripes(
    pupsdf,
    cols=None,
    rows=None,
    col_order=None,
    row_order=None,
    vmin=None,
    vmax=None,
    sym=True,
    cmap="coolwarm",
    cmap_emptypixel=(0.98, 0.98, 0.98),
    scale="log",
    height=1.5,
    aspect="auto",
    stripe="corner_stripe",
    stripe_sort="sum",
    out_sorted_bedpe=None,
    font_scale=1,
    plot_ticks=False,
    colnames=None,
    rownames=None,
    lineplot=False,
    cbar_mode="single",
    **kwargs,
):
    """Stripe stack-up grids (reference plotpup.py:290–669); lineplot=True
    adds a mean-profile panel above EVERY stack-up row (the reference's
    add_stripe_lineplot handles only single panels, plotpup.py:189–261)."""
    pupsdf = pupsdf.copy().reset_index(drop=True)
    if not {"vertical_stripe", "horizontal_stripe"}.issubset(pupsdf.columns):
        raise ValueError("No stripes stored in pup")
    if stripe not in (
        "horizontal_stripe",
        "vertical_stripe",
        "corner_stripe",
    ):
        raise ValueError(
            "stripe can only be 'vertical_stripe', 'horizontal_stripe' or "
            "'corner_stripe'"
        )
    cols, rows, col_order, row_order = _facet_orders(
        pupsdf, cols, rows, col_order, row_order
    )
    ncols, nrows = len(col_order), len(row_order)
    pupsdf = make_corner_stripes(pupsdf)
    if stripe_sort is not None:
        pupsdf = sort_stripes(pupsdf, stripe, stripe_sort, out_sorted_bedpe)
    vmin, vmax = get_min_max(pupsdf["data"].values, vmin, vmax, sym, scale)
    norm_cls = {"log": LogNorm, "linear": Normalize}.get(scale)
    if norm_cls is None:
        raise ValueError(f"Unknown scale value {scale}")
    norm = norm_cls(vmin, vmax)
    cmap = plt.get_cmap(cmap).copy()
    cmap.set_bad(cmap_emptypixel)

    fig, axarr = plt.subplots(
        nrows * (2 if lineplot else 1),
        ncols,
        figsize=(height * ncols + 0.7, height * nrows * (3 if lineplot else 2)),
        squeeze=False,
        gridspec_kw=(
            {"height_ratios": [1, 5] * nrows} if lineplot else None
        ),
    )
    fontsize = font_scale * (4.94 + height) * 2
    # with lineplots, heatmap rows are the odd grid rows (profile above each)
    heat_axes = axarr[1::2] if lineplot else axarr
    for ri, rval in enumerate(row_order):
        for ci, cval in enumerate(col_order):
            ax = heat_axes[ri][ci]
            sel = _select(pupsdf, cols, rows, cval, rval)
            if len(sel) == 0:
                ax.axis("off")
                if lineplot:
                    axarr[2 * ri][ci].axis("off")
                continue
            row = sel.iloc[0]
            data = np.asarray(row[stripe])
            if lineplot:
                lax = axarr[2 * ri][ci]
                mean = np.nanmean(data, axis=0)
                if scale == "log":
                    with np.errstate(divide="ignore"):
                        mean = np.log(mean)
                    mean = np.where(mean == -np.inf, 0, mean)
                lax.plot(np.arange(len(mean)), mean)
                lax.spines["right"].set_visible(False)
                lax.spines["top"].set_visible(False)
                lax.set_xticks([])
            ax.imshow(
                data,
                cmap=cmap,
                norm=norm,
                aspect=aspect,
                interpolation="none",
            )
            if plot_ticks:
                ax.tick_params(axis="both", labelsize=fontsize * 0.7)
            else:
                ax.set_xticks([])
                ax.set_yticks([])
            if ri == nrows - 1 and cval is not None:
                ax.set_xlabel(
                    colnames[ci] if colnames else cval, fontsize=fontsize
                )
            if ci == 0 and rval is not None:
                ax.set_ylabel(
                    rownames[ri] if rownames else rval,
                    rotation=0,
                    ha="right",
                    fontsize=fontsize,
                )
    fig.subplots_adjust(wspace=0.05, hspace=0.05, right=ncols / (ncols + 0.25))
    _add_colorbars(fig, heat_axes, norm, cmap, sym, scale, cbar_mode)
    return fig
