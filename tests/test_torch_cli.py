"""The port's three command line tools against the JAX package's, on the
CPU, on the same files: ``coolpup`` over ``torch_cases``' CLI flag sets
(the port with ``--device cpu``), each ``.clpy`` loaded by both packages'
``load_pileup_df``; the automatic output name; ``dividepups``; ``plotpup``'s
PNG and sorted BEDPE; the three parsers' flags, aliases and defaults; and
``--device cuda`` where torch sees no card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# matplotlib, and h5py that the JAX package imports, are missing on the
# card's machine: there this module skips
pytest.importorskip("matplotlib")
pytest.importorskip("h5py")

from matplotlib.image import imread
from coolpuppy_tpu.cli import coolpup_cli as ref_coolpup
from coolpuppy_tpu.cli import dividepups_cli as ref_dividepups
from coolpuppy_tpu.cli import plotpup_cli as ref_plotpup
from coolpuppy_tpu.io import load_pileup_df as ref_load
from coolpuppy_tpu_torch.cli import coolpup_cli, dividepups_cli, plotpup_cli
from coolpuppy_tpu_torch.io import load_pileup_df

from fixtures import make_toy_cooler
import torch_cases

REPO = Path(__file__).resolve().parent.parent

# the port's own annotation columns: the device, the accumulate routes the
# regions took, and the reference keywords it accepts and ignores
PORT_ONLY = {"backend", "device", "accumulate", "ignored"}
PILEUP_COLS = {"data", "num", "control_num", "n", "control_n",
               "vertical_stripe", "horizontal_stripe", "coordinates"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The toy map written by the JAX package's ``write_cool``, and the
    features, BEDPE rows, TADs, view and expected table of
    ``torch_cases.CLI_FLAG_SETS`` beside it."""
    d = tmp_path_factory.mktemp("cli_inputs")
    clr, dense, weights = make_toy_cooler(str(d / "toy.cool"), seed=2)
    paths = torch_cases.write_cli_inputs(str(d), clr, dense, weights)
    assert paths["cool"] == str(d / "toy.cool")
    return paths


def _main(main, argv, cwd, paths, monkeypatch):
    """Run one CLI's ``main`` in ``cwd``, features given as "-" read from
    the BED file on standard input."""
    monkeypatch.chdir(cwd)
    with open(paths["bed"]) as stdin:
        monkeypatch.setattr(sys, "stdin", stdin)
        return os.path.join(cwd, main(argv))


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return bool(a == b)


def assert_same_columns(got, want, cols, what):
    for col in cols:
        for i, (g, w) in enumerate(zip(got[col], want[col])):
            assert _same(g, w), f"{what}: {col} of row {i}: {g!r} != {w!r}"


def assert_same_frames(port, ref, what):
    """A port table against the reference's: the port's own columns on the
    port's side only, the pileup columns by ``torch_cases.compare_tables``
    (counts exact, ``data`` rtol 1e-5, stripes rtol 1e-5, coordinates
    equal), every other column equal."""
    assert set(port.columns) - set(ref.columns) <= PORT_ONLY, what
    assert set(ref.columns) <= set(port.columns), what
    torch_cases.compare_tables(port, ref, what=what,
                               **torch_cases.ENGINE_MODES_TOL)
    assert_same_columns(port, ref, sorted(set(ref.columns) - PILEUP_COLS),
                        what)


@pytest.mark.parametrize("name", list(torch_cases.CLI_FLAG_SETS))
def test_coolpup_matches_reference(name, inputs, tmp_path, monkeypatch):
    """Both packages' coolpup on one flag set, auto-named in two
    directories: the same output name, and each file loaded by both
    packages' ``load_pileup_df``: the loads of one file equal, and the
    port's file equal to the reference's on the shared columns."""
    argv = torch_cases.cli_argv(name, inputs)
    port_argv = argv + ["--device", "cpu"]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    if name in torch_cases.CLI_REFUSED:
        for main, args in ((ref_coolpup.main, argv),
                           (coolpup_cli.main, port_argv)):
            with pytest.raises(ValueError) as e:
                _main(main, args, str(tmp_path), inputs, monkeypatch)
            assert str(e.value) == torch_cases.CLI_REFUSED[name]
        return
    ref_out = _main(ref_coolpup.main, argv, str(tmp_path / "ref"), inputs,
                    monkeypatch)
    port_out = _main(coolpup_cli.main, port_argv, str(tmp_path / "port"),
                     inputs, monkeypatch)
    assert os.path.basename(port_out) == os.path.basename(ref_out)
    want = ref_load(ref_out)
    for path in (ref_out, port_out):
        a, b = ref_load(path), load_pileup_df(path)
        assert list(a.columns) == list(b.columns)
        assert_same_columns(a, b, a.columns, f"{name}: loads of {path}")
    got = load_pileup_df(port_out)
    assert got["device"].iloc[0] == "cpu"
    assert_same_frames(got, want, f"coolpup {name}")


def test_auto_name_matches_reference(inputs, tmp_path, monkeypatch):
    """``tests/test_cli.py``'s auto-name case: no controls, unbalanced,
    stripes, no ignored diagonals."""
    argv = [inputs["cool"], inputs["bed"], "--view", inputs["regions"],
            "--flank", "2000000", "--mindist", "0", "--nshifts", "0",
            "--clr_weight_name", "--store_stripes", "--ignore_diags", "0"]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_out = _main(ref_coolpup.main, argv, str(tmp_path / "ref"), inputs,
                    monkeypatch)
    port_out = _main(coolpup_cli.main, argv + ["--device", "cpu"],
                     str(tmp_path / "port"), inputs, monkeypatch)
    name = os.path.basename(port_out)
    assert name == os.path.basename(ref_out)
    assert name == "toy.cool-1000.0K_over_features_noNorm_dist_0-inf.clpy"
    assert_same_frames(load_pileup_df(port_out), ref_load(ref_out),
                       "auto-name case")


def _coolpup_outputs(main, inputs, tmp_path, monkeypatch, *runs):
    """``.clpy`` files written by ``main`` (a package's coolpup), one for
    each ``(flag set, extra flags, file name)`` of ``runs``."""
    return [_main(main, torch_cases.cli_argv(name, inputs) + list(extra)
                  + ["-o", str(tmp_path / out)], str(tmp_path), inputs,
                  monkeypatch)
            for name, extra, out in runs]


def _port_coolpup(argv):
    return coolpup_cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dividepups_matches_reference(writer, inputs, tmp_path,
                                      monkeypatch):
    """Both packages' dividepups on the same two single-row files (written
    by either package's coolpup): equal tables."""
    main = ref_coolpup.main if writer == "reference" else _port_coolpup
    one, two = _coolpup_outputs(main, inputs, tmp_path, monkeypatch,
                                ("bed", ["--nshifts", "1"], "one.clpy"),
                                ("bed", ["--nshifts", "2"], "two.clpy"))
    ref_out = ref_dividepups.main([one, two, "-o",
                                   str(tmp_path / "ref_div.clpy")])
    port_out = dividepups_cli.main([one, two, "-o",
                                    str(tmp_path / "port_div.clpy")])
    want, got = ref_load(ref_out), load_pileup_df(port_out)
    assert list(got.columns) == list(want.columns)
    assert np.isfinite(got["data"].iloc[0]).any()
    assert not np.array_equal(got["data"].iloc[0], load_pileup_df(one)[
        "data"].iloc[0], equal_nan=True)
    assert_same_columns(got, want, got.columns, f"dividepups ({writer})")


@pytest.mark.parametrize("stripe", [False, True])
def test_plotpup_matches_reference(stripe, inputs, tmp_path, monkeypatch):
    """Both packages' plotpup writing a PNG from the same ``.clpy``: equal
    pixels; with ``--stripe corner_stripe`` equal sorted BEDPE files."""
    name = "store_stripes" if stripe else "by_strand"
    (clpy,) = _coolpup_outputs(ref_coolpup.main, inputs, tmp_path,
                               monkeypatch, (name, [], "in.clpy"))
    files = {}
    for side, main in (("ref", ref_plotpup.main), ("port", plotpup_cli.main)):
        argv = ["--input_pups", clpy, "--output", str(tmp_path / f"{side}.png"),
                "--no_score", "--dpi", "60"]
        if stripe:
            argv += ["--stripe", "corner_stripe", "--out_sorted_bedpe",
                     str(tmp_path / f"{side}.bedpe")]
        else:
            argv += ["--rows", "orientation"]
        files[side] = main(argv)
    np.testing.assert_array_equal(imread(files["port"]), imread(files["ref"]))
    if stripe:
        port_bedpe = (tmp_path / "port.bedpe").read_text()
        assert port_bedpe == (tmp_path / "ref.bedpe").read_text()
        assert len(port_bedpe.splitlines()) == 6


@pytest.mark.parametrize("tool", ["coolpup", "plotpup", "dividepups"])
def test_parser_matches_reference(tool):
    """Every option of the reference's parser in the port's, with the same
    aliases, destination, default, choices and arity; the port adds
    ``--device`` (default cuda) to coolpup alone, and says in its help that
    it reads and writes files through h5py."""
    ref_parser, port_parser = {
        "coolpup": (ref_coolpup.parse_args_coolpuppy,
                    coolpup_cli.parse_args_coolpuppy),
        "plotpup": (ref_plotpup.parse_args_plotpuppy,
                    plotpup_cli.parse_args_plotpuppy),
        "dividepups": (ref_dividepups.parse_args_divide_pups,
                       dividepups_cli.parse_args_divide_pups),
    }[tool]
    ref_parser, port_parser = ref_parser(), port_parser()

    def actions(parser):
        return {a.dest: a for a in parser._actions}

    ref_actions, port_actions = actions(ref_parser), actions(port_parser)
    added = set(port_actions) - set(ref_actions)
    assert added == ({"device"} if tool == "coolpup" else set())
    for dest, want in ref_actions.items():
        got = port_actions[dest]
        assert got.option_strings == want.option_strings, dest
        if dest != "version":
            assert got.default == want.default, dest
        assert got.choices == want.choices, dest
        assert got.nargs == want.nargs, dest
        assert got.const == want.const, dest
    if tool == "coolpup":
        assert port_actions["device"].default == "cuda"
        text = port_parser.format_help()
        assert "--device" in text and "h5py" in text


def test_coolpup_needs_a_card_for_device_cuda(inputs, tmp_path):
    """``--device cuda`` (the default) where torch sees no card: a non-zero
    exit naming the device, and no output file (no run on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here")
    out = tmp_path / "out.clpy"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    res = subprocess.run(
        [sys.executable, "-m", "coolpuppy_tpu_torch.cli.coolpup_cli",
         inputs["cool"], inputs["bed"], "--view", inputs["regions"],
         "-o", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert "device='cuda'" in res.stderr and "no CUDA device" in res.stderr
    assert not out.exists()
