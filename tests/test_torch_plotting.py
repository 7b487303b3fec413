"""The port's ``plotting`` against the JAX package's, on the CPU: ``plot``
and ``plot_stripes`` of both packages on the same pups frame, for each
colour-bar mode, grid wrapping and scale. The figures must hold the same
axes, the same image arrays (NaN positions equal), the same norms and the
same labels and texts."""

from contextlib import nullcontext

import numpy as np
import pytest

# matplotlib, and h5py that the JAX package imports, are missing on the
# card's machine: there this module skips
pytest.importorskip("matplotlib")
pytest.importorskip("h5py")

import matplotlib.pyplot as plt
import coolpuppy_tpu.plotting as ref_plotting
import coolpuppy_tpu_torch.plotting as port_plotting
from coolpuppy_tpu_torch import pileup
import torch_cases


@pytest.fixture(scope="module")
def pups():
    """The port's pileups of the toy map by strand, one control, with
    stripes: five rows, 5 x 5 windows."""
    clr = torch_cases.toy_cooler()[0]
    return pileup(clr, torch_cases.toy_features(),
                  view_df=torch_cases.toy_regions(), mindist=0,
                  flank=2_000_000, nshifts=1, seed=0, by_strand=True,
                  store_stripes=True, device="cpu")


def _figure_record(fig):
    """What a figure shows: per axes its position, labels, texts, and each
    image's array (masked cells as NaN) and norm."""
    rec = []
    for ax in fig.axes:
        images = []
        for im in ax.get_images():
            arr = np.ma.filled(np.ma.asarray(im.get_array(), float), np.nan)
            images.append((arr, type(im.norm).__name__, im.norm.vmin,
                           im.norm.vmax))
        rec.append(dict(
            position=tuple(np.round(ax.get_position().bounds, 12)),
            visible=ax.axison, xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
            texts=[t.get_text() for t in ax.texts], images=images,
            lines=[np.asarray(ln.get_ydata(), float) for ln in ax.lines],
        ))
    return rec


def assert_same_figures(got, want, what):
    g, w = _figure_record(got), _figure_record(want)
    assert len(g) == len(w), f"{what}: {len(g)} axes, not {len(w)}"
    assert sum(len(a["images"]) for a in w) > 0, what
    for i, (a, b) in enumerate(zip(g, w)):
        for key in ("position", "visible", "xlabel", "ylabel", "texts"):
            assert a[key] == b[key], f"{what}: axes {i} {key}"
        assert len(a["images"]) == len(b["images"]), f"{what}: axes {i}"
        for (ga, gn, gmin, gmax), (wa, wn, wmin, wmax) in zip(a["images"],
                                                              b["images"]):
            np.testing.assert_array_equal(ga, wa, err_msg=f"{what}: axes {i}")
            assert (gn, gmin, gmax) == (wn, wmin, wmax), f"{what}: axes {i}"
        assert len(a["lines"]) == len(b["lines"]), f"{what}: axes {i}"
        for ga, wa in zip(a["lines"], b["lines"]):
            np.testing.assert_array_equal(ga, wa, err_msg=f"{what}: axes {i}")


def _both(fn_name, pups, **kw):
    figs = []
    for mod in (port_plotting, ref_plotting):
        figs.append(getattr(mod, fn_name)(pups, **kw))
    try:
        assert_same_figures(*figs, what=f"{fn_name} {kw}")
    finally:
        for fig in figs:
            plt.close(fig)


PLOT_CASES = {
    "single": dict(rows="orientation", score=False),
    "edge": dict(rows="orientation", score=False, cbar_mode="edge"),
    "each": dict(rows="orientation", score=False, cbar_mode="each"),
    "wrap_cols": dict(cols="orientation", score=False, n_cols=2),
    "wrap_rows": dict(cols="orientation", score=False, n_rows=2),
    "auto_facets": dict(score=False),
    "linear": dict(rows="orientation", score=False, scale="linear",
                   sym=False),
    "log_vmin": dict(cols="orientation", score=False, vmin=0.5),
    "scores": dict(rows="orientation", center=1, ignore_central=1),
    "norm_corners": dict(rows="orientation", score=False, norm_corners=1,
                         plot_ticks=True),
}


@pytest.mark.parametrize("case", list(PLOT_CASES))
def test_plot_matches_reference(case, pups):
    _both("plot", pups, **PLOT_CASES[case])


STRIPE_CASES = {
    "corner_single": dict(rows="orientation"),
    "corner_edge": dict(rows="orientation", cbar_mode="edge"),
    "corner_each": dict(rows="orientation", cbar_mode="each"),
    "vertical_linear": dict(cols="orientation", stripe="vertical_stripe",
                            scale="linear", sym=False),
    "horizontal_center_sort": dict(rows="orientation",
                                   stripe="horizontal_stripe",
                                   stripe_sort="center_pixel"),
    "lineplot": dict(rows="orientation", lineplot=True),
}


@pytest.mark.parametrize("case", list(STRIPE_CASES))
def test_plot_stripes_matches_reference(case, pups):
    _both("plot_stripes", pups, **STRIPE_CASES[case])


def test_sort_stripes_and_min_max_match_reference(pups, tmp_path):
    """``sort_stripes`` (the rows, and the sorted BEDPE written for one
    condition; several conditions of other regions are left unsorted, with
    a warning) and ``get_min_max`` of both packages on the same frame."""
    one = pups[pups["orientation"] == "all"]
    for frame, rows in ((one, 6), (pups, 0)):
        sorted_frames, beds = [], []
        for i, mod in enumerate((port_plotting, ref_plotting)):
            path = tmp_path / f"sorted_{len(frame)}_{i}.bedpe"
            with pytest.warns(UserWarning) if rows == 0 else nullcontext():
                sorted_frames.append(mod.sort_stripes(
                    mod.make_corner_stripes(frame), "corner_stripe",
                    out_sorted_bedpe=str(path)))
            beds.append(path.read_text() if path.exists() else "")
        assert beds[0] == beds[1] and len(beds[0].splitlines()) == rows
        for col in ("coordinates", "corner_stripe", "vertical_stripe",
                    "horizontal_stripe"):
            for a, b in zip(sorted_frames[0][col], sorted_frames[1][col]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    data = pups["data"].values
    for kw in ({}, {"vmin": 0.5}, {"vmax": 2.0}, {"sym": False},
               {"scale": "linear"}):
        assert (port_plotting.get_min_max(data, **kw)
                == ref_plotting.get_min_max(data, **kw)), kw
