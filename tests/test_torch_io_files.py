"""The port's file formats against the JAX package's, on the CPU, on the
same files: ``.clpy`` pileups written by one package and read by the other,
the pandas fixed-format annotation table, ``write_cool``, the BED/BEDPE/
expected readers and the ``.txt`` arrays."""

import gzip

import numpy as np
import pandas as pd
import pytest

# h5py, which this module and the JAX package it compares against import,
# is missing on the card's machine: there the module skips
h5py = pytest.importorskip("h5py")

import coolpuppy_tpu.io as ref_io
import coolpuppy_tpu.io.bedio as ref_bedio
import coolpuppy_tpu.io.pandas_hdf as ref_hdf
import coolpuppy_tpu_torch.io as port_io
import coolpuppy_tpu_torch.io.bedio as port_bedio
import coolpuppy_tpu_torch.io.pandas_hdf as port_hdf
from coolpuppy_tpu_torch import Cooler, pileup

from fixtures import make_toy_cooler
from test_torch_cli import assert_same_columns
import torch_cases

IO = {"reference": ref_io, "port": port_io}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``torch_cases.write_cli_inputs``' files for the toy map (written by
    the JAX package's ``write_cool``), a gzipped copy of the BED file, and
    the reference's ``Cooler`` of the map."""
    d = tmp_path_factory.mktemp("io_files")
    clr, dense, weights = make_toy_cooler(str(d / "toy.cool"), seed=5)
    paths = torch_cases.write_cli_inputs(str(d), clr, dense, weights)
    paths["bed_gz"] = str(d / "features.bed.gz")
    with open(paths["bed"], "rb") as src, gzip.open(paths["bed_gz"], "wb") as f:
        f.write(src.read())
    return paths, clr


def assert_frames_equal(got, want, what):
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    assert_same_columns(got, want, want.columns, what)


@pytest.fixture(scope="module")
def pups():
    """The port's pileups on the toy map (``torch_cases.toy_cooler``), by
    strand with one control, without and with stripes."""
    clr = torch_cases.toy_cooler()[0]
    return {stripes: pileup(clr, torch_cases.toy_features(),
                            view_df=torch_cases.toy_regions(), mindist=0,
                            flank=2_000_000, nshifts=1, seed=0,
                            by_strand=True, store_stripes=stripes,
                            device="cpu")
            for stripes in (False, True)}


@pytest.mark.parametrize("stripes", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_clpy_between_packages(writer, stripes, pups, tmp_path):
    """A ``.clpy`` written by one package loads in both, to equal frames
    that hold the pileup written (data and stripes exact, coordinates
    equal, the metadata as columns)."""
    df = pups[stripes]
    path = str(tmp_path / "pups.clpy")
    IO[writer].save_pileup_df(path, df, metadata={"note": "toy", "x": None})
    ref = ref_io.load_pileup_df(path)
    port = port_io.load_pileup_df(path)
    assert_frames_equal(port, ref, f"{writer} writer")
    assert "version" not in port.columns
    assert list(port["note"]) == ["toy"] * len(df)
    assert list(port["x"]) == [False] * len(df)
    cols = ["data", "n", "control_n", "orientation", "group", "device"]
    if stripes:
        cols += ["vertical_stripe", "horizontal_stripe", "coordinates"]
    else:
        assert "vertical_stripe" not in port.columns
    assert_frames_equal(port[cols], df[cols].reset_index(drop=True),
                        f"{writer} writer vs the pileup")
    both = port_io.load_pileup_df_list([path, path])
    assert list(both["norm"]) == ["shifts"] * (2 * len(df))
    assert_frames_equal(both, ref_io.load_pileup_df_list([path, path]),
                        f"{writer} writer, load_pileup_df_list")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fixed_frame_between_packages(writer, tmp_path):
    """The pandas fixed-format table written by one package reads back
    equal through both packages' ``read_fixed_frame``."""
    df = pd.DataFrame({
        "group": ["+-", "-+", "all"],
        "n": np.array([3, 5, 8], dtype=np.int64),
        "score": np.array([0.5, np.nan, 2.0]),
        "flag": [True, False, True],
        "band": [(0, 50000), (50000, 100000), ()],
    })
    path = tmp_path / "fixed.h5"
    write = {"reference": ref_hdf, "port": port_hdf}[writer].write_fixed_frame
    with h5py.File(path, "w") as f:
        write(f, "annotation", df)
    with h5py.File(path, "r") as f:
        ref = ref_hdf.read_fixed_frame(f, "annotation")
        port = port_hdf.read_fixed_frame(f, "annotation")
    assert_frames_equal(port, ref, writer)
    assert_frames_equal(port.reset_index(drop=True), df, f"{writer} vs df")


def test_fixed_frame_read_by_pandas(pups, tmp_path):
    """The annotation table the port writes reads back through
    ``pd.read_hdf`` where PyTables exists."""
    pytest.importorskip("tables")
    path = str(tmp_path / "pups.clpy")
    port_io.save_pileup_df(path, pups[False])
    back = pd.read_hdf(path, "annotation")
    assert list(back["orientation"]) == list(pups[False]["orientation"])
    assert list(back["n"]) == list(pups[False]["n"])


@pytest.mark.parametrize("counts", ["int", "float"])
def test_write_cool_read_by_both(counts, tmp_path):
    """``write_cool`` of the port read by the JAX ``Cooler`` and by the
    port's ``Cooler.from_cool``: the same pixels, bins and weights as the
    reference's ``write_cool`` of the same arrays."""
    rng = np.random.default_rng(3)
    chromsizes = {"chrA": 2_350_000, "chrB": 1_000_000}
    n_bins = 24 + 10
    b1 = rng.integers(0, n_bins, 400)
    b2 = rng.integers(0, n_bins, 400)
    b1, b2 = np.minimum(b1, b2), np.maximum(b1, b2)
    count = rng.poisson(4.0, 400) + 1
    if counts == "float":
        count = count * 0.5
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < 0.1] = np.nan
    cov = rng.random(n_bins)
    ref_path, port_path = str(tmp_path / "ref.cool"), str(tmp_path / "p.cool")
    for io, path in ((ref_io, ref_path), (port_io, port_path)):
        io.write_cool(path, chromsizes, 100_000, (b1, b2, count),
                      weights=weights, extra_bin_cols={"cov": cov})
    want = ref_io.Cooler(ref_path)
    for got in (ref_io.Cooler(port_path), Cooler.from_cool(port_path)):
        assert got.binsize == 100_000
        assert got.chromnames == ["chrA", "chrB"]
        assert dict(got.chromsizes) == chromsizes
        nnz = want.pixels_chunk(0, 10**6)[0].shape[0]
        for g, w in zip(got.pixels_chunk(0, 10**6),
                        want.pixels_chunk(0, 10**6)):
            np.testing.assert_array_equal(g, w)
        assert nnz == 400
        gb, wb = got.bins_df(), want.bins_df()
        for col in ("chrom", "start", "end", "weight", "cov"):
            np.testing.assert_array_equal(np.asarray(gb[col]),
                                          np.asarray(wb[col]))
    with h5py.File(port_path, "r") as f, h5py.File(ref_path, "r") as g:
        assert f["pixels/count"].dtype == g["pixels/count"].dtype
        np.testing.assert_array_equal(f["indexes/bin1_offset"][:],
                                      g["indexes/bin1_offset"][:])


@pytest.mark.parametrize("name", ["bed", "bed_header", "bed_gz", "bedpe",
                                  "tads", "regions", "expected"])
def test_sniff_and_read_table(name, files):
    """``sniff_for_header`` and ``read_table``/``read_features`` of both
    packages on the same file."""
    paths, _ = files
    path = paths[name]
    rbuf, rnames, rncols = ref_bedio.sniff_for_header(path)
    pbuf, pnames, pncols = port_bedio.sniff_for_header(path)
    assert (pnames, pncols) == (rnames, rncols)
    assert pbuf.read() == rbuf.read()
    assert (pnames is not None) == (name in ("bed_header", "expected"))
    if name == "expected":
        return
    schema = {"bedpe": "bedpe6", "regions": "bed4"}.get(name, "bed6")
    if name != "bed_header":
        assert_frames_equal(port_bedio.read_table(path, schema=schema),
                            ref_bedio.read_table(path, schema=schema), name)
    want, wfmt = ref_bedio.read_features(path)
    got, gfmt = port_bedio.read_features(path)
    # both packages take any headerless table of 6+ columns for BEDPE here
    # (the CLI reads by the file's extension instead)
    assert gfmt == wfmt == ("bed" if name in ("bed_header", "regions")
                            else "bedpe")
    assert_frames_equal(got, want, name)


def test_viewframe_expected_and_validate_csv(files, tmp_path):
    """``read_viewframe_from_file``, ``read_expected_from_file`` and
    ``validate_csv`` of both packages on the same files, and the same
    errors for a missing path and a view outside the map."""
    paths, clr = files
    for verify in (None, clr):
        assert_frames_equal(
            port_bedio.read_viewframe_from_file(paths["regions"],
                                                verify_cooler=verify),
            ref_bedio.read_viewframe_from_file(paths["regions"],
                                               verify_cooler=verify),
            "view")
    view = ref_bedio.read_viewframe_from_file(paths["regions"])
    for kw in ({}, {"verify_view": view, "verify_cooler": clr}):
        assert_frames_equal(
            port_bedio.read_expected_from_file(paths["expected"], **kw),
            ref_bedio.read_expected_from_file(paths["expected"], **kw),
            "expected")
    for value in (None, paths["expected"], f"{paths['expected']}::count.sum",
                  f"{paths['expected']}::6"):
        assert port_bedio.validate_csv(value) == ref_bedio.validate_csv(value)
    for mod in (ref_bedio, port_bedio):
        with pytest.raises(ValueError, match="Path not found"):
            mod.validate_csv(str(tmp_path / "missing.tsv"))
    far = tmp_path / "far.bed"
    far.write_text("chr1\t0\t900000000\tall\nchr2\t0\t1000\tb\n")
    errors = []
    for mod in (ref_bedio, port_bedio):
        with pytest.raises(ValueError) as e:
            mod.read_viewframe_from_file(str(far), verify_cooler=clr)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    # a headerless one-region view: both packages' sniffing takes its one
    # line for a header, and the view comes back empty
    one = tmp_path / "one.bed"
    one.write_text("chr1\t0\t100000000\tfoo\n")
    views = [mod.read_viewframe_from_file(str(one))
             for mod in (ref_bedio, port_bedio)]
    assert_frames_equal(views[1], views[0], "one-line view")
    assert len(views[1]) == 0


@pytest.mark.parametrize("reader", ["reference", "port"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_txt_between_packages(writer, reader, tmp_path):
    """A ``.txt`` array with its YAML header written by one package and
    read by the other: the array exact, the header equal."""
    path = str(tmp_path / "arr.txt")
    rng = np.random.default_rng(1)
    arr = rng.random((7, 7))
    arr[2, 3] = np.nan
    header = {"flank": 100000, "local": False, "score": 1.5,
              "maxdist": np.inf, "groupby": ["strand1", "strand2"],
              "expected": None, "cool": "some.cool", "name": "a: b"}
    IO[writer].save_array_with_header(arr, header, path)
    out = IO[reader].load_array_with_header(path)
    np.testing.assert_array_equal(out.pop("data"), arr)
    assert out == header
