"""coolpup-torch: the main pile-up CLI of the port (counterpart of
``coolpuppy_tpu/cli/coolpup_cli.py``, same flag surface; reference
CLI.py:21–350 for flags, :353–603 for its body), plus ``--device``.

``main`` reads the ``.cool`` file with ``Cooler(uri)`` (a fetch's row span
at a time) and writes the ``.clpy`` file through h5py; everything between
those two calls is ``pileup_from_args``, which needs neither h5py nor a file
of the map: it takes any ``Cooler``."""

from __future__ import annotations

import argparse
import logging
import os
import pdb
import sys
import traceback

import numpy as np
import pandas as pd

from .._version import __version__
from ..engine import pileup
from ..genomics.intervals import make_cooler_view
from ..io import (
    Cooler,
    read_expected_from_file,
    read_viewframe_from_file,
    save_pileup_df,
    sniff_for_header,
    validate_csv,
)
from ..io.bedio import BED_SCHEMA, BEDPE_SCHEMA

logger = logging.getLogger("coolpuppy_tpu_torch")


def parse_args_coolpuppy():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Pile up Hi-C snippets around features on a CUDA card "
        "(or the CPU with --device cpu). Reads the .cool file and writes "
        "the .clpy file through h5py.",
    )
    parser.add_argument("cool_path", type=str, help="Cooler file with your Hi-C data")
    parser.add_argument(
        "features",
        type=str,
        help="A bed or bedpe file with coordinates; '-' reads from stdin",
    )
    parser.add_argument(
        "--features_format",
        "--features-format",
        "--format",
        "--basetype",
        type=str,
        choices=["bed", "bedpe", "auto"],
        default="auto",
    )
    parser.add_argument("--view", type=str, default=None)
    parser.add_argument("--flank", "--pad", default=100_000, type=int)
    parser.add_argument("--minshift", default=10**5, type=int)
    parser.add_argument("--maxshift", default=10**6, type=int)
    parser.add_argument("--nshifts", default=10, type=int)
    parser.add_argument("--expected", default=None, type=validate_csv)
    parser.add_argument(
        "--not_ooe", "--not-ooe", dest="ooe", default=True, action="store_false"
    )
    parser.add_argument("--mindist", type=int, default=None)
    parser.add_argument("--maxdist", type=int, default=None)
    parser.add_argument("--ignore_diags", "--ignore-diags", type=int, default=2)
    parser.add_argument("--subset", default=0, type=int)
    parser.add_argument(
        "--by_window", "--by-window", action="store_true", default=False
    )
    parser.add_argument(
        "--by_strand", "--by-strand", action="store_true", default=False
    )
    parser.add_argument("--by_distance", "--by-distance", nargs="*", default=None)
    parser.add_argument("--groupby", nargs="*", default=None)
    parser.add_argument("--ignore_group_order", nargs="*", default=None)
    parser.add_argument(
        "--flip_negative_strand",
        "--flip-negative-strand",
        action="store_true",
        default=False,
    )
    parser.add_argument("--local", action="store_true", default=False)
    parser.add_argument(
        "--coverage_norm",
        "--coverage-norm",
        default="",
        type=str,
        nargs="?",
        const="total",
    )
    parser.add_argument("--trans", action="store_true", default=False)
    parser.add_argument("--store_stripes", action="store_true", default=False)
    parser.add_argument("--rescale", action="store_true", default=False)
    parser.add_argument(
        "--rescale_flank",
        "--rescale_pad",
        "--rescale-flank",
        "--rescale-pad",
        default=1.0,
        type=float,
    )
    parser.add_argument("--rescale_size", "--rescale-size", type=int, default=99)
    parser.add_argument(
        "--clr_weight_name",
        "--weight_name",
        "--clr-weight-name",
        "--weight-name",
        default="weight",
        type=str,
        nargs="?",
        const=None,
    )
    parser.add_argument("-o", "--outname", "--output", default="auto", type=str)
    parser.add_argument(
        "-p", "--nproc", "--n_proc", "--n-proc", default=1, type=int, dest="n_proc"
    )
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument(
        "--device",
        default="cuda",
        type=str,
        help="Where to pile up: 'cuda' (the hand-written CUDA kernel; fails "
        "if torch sees no card) or 'cpu' (the plain PyTorch version)",
    )
    parser.add_argument(
        "-l",
        "--log",
        dest="logLevel",
        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"],
        default="INFO",
    )
    parser.add_argument(
        "--post_mortem", "--post-mortem", action="store_true", default=False
    )
    parser.add_argument("-v", "--version", action="version", version=__version__)
    return parser


def _read_features(path, features_format):
    """Features from a file or stdin with header sniffing (reference
    CLI.py:406–475)."""
    if path != "-":
        bedname, ext = os.path.splitext(os.path.basename(path))
        buf, names, ncols = sniff_for_header(path)
        schema = ext[1:] if features_format == "auto" else features_format
    else:
        if features_format == "auto":
            raise ValueError(
                "Can't determine format when features is piped in, please specify"
            )
        bedname = "stdin"
        buf, names, ncols = sniff_for_header(sys.stdin)
        schema = features_format

    if schema == "bed":
        features_format = "bed"
        base_schema = BED_SCHEMA + ["c7", "c8", "c9", "c10", "c11", "c12"]
        dtypes = {"chrom": str, "start": np.int64, "end": np.int64}
    else:
        features_format = "bedpe"
        base_schema = BEDPE_SCHEMA
        dtypes = {
            "chrom1": str,
            "start1": np.int64,
            "end1": np.int64,
            "chrom2": str,
            "start2": np.int64,
            "end2": np.int64,
        }
    if features_format == "bedpe" and ncols < 6:
        raise ValueError("Too few columns")
    if ncols < 3:
        raise ValueError("Too few columns")
    if names is not None:
        features = pd.read_table(buf, dtype=dtypes)
    else:
        features = pd.read_table(
            buf, header=None, names=base_schema[:ncols], dtype=dtypes
        )
    for col in features.columns:
        if str(col).startswith(("chrom", "strand")):
            features[col] = features[col].astype(str)
    return features, features_format, bedname


def pileup_from_args(args, clr):
    """The pileup that ``main`` saves, from parsed arguments and an open
    ``Cooler`` (whose ``filename`` names the map in the output name): reads
    the features, view and expected files, resolves the distance edges,
    runs ``pileup()`` on ``args.device`` and adds the CLI's annotation
    columns. Returns ``(pups, outname)``."""
    if args.by_distance is not None:
        if len(args.by_distance) > 0:
            try:
                distance_edges = [int(item) for item in args.by_distance]
            except Exception as e:
                raise ValueError(
                    "Distance edges must be integers. Separate edges with spaces."
                ) from e
        else:
            distance_edges = True
    else:
        distance_edges = False

    if args.ignore_group_order is not None:
        ignore_group_order = (
            [str(i) for i in args.ignore_group_order]
            if len(args.ignore_group_order) > 0
            else True
        )
    else:
        ignore_group_order = False

    nproc = -1 if args.n_proc == 0 else args.n_proc

    coolname = os.path.basename(clr.filename)
    features, features_format, bedname = _read_features(
        args.features, args.features_format
    )

    if args.view is None:
        view_df = make_cooler_view(clr)
    else:
        view_df = read_viewframe_from_file(args.view, verify_cooler=clr)

    if args.expected is None:
        expected = None
        expected_value_col = None
        expected_path = None
    else:
        expected_path, expected_value_col = args.expected
        expected = read_expected_from_file(
            expected_path,
            expected_value_cols=[expected_value_col],
            verify_view=view_df,
            verify_cooler=clr,
        )
        args.nshifts = 0

    mindist = "auto" if args.mindist is None else args.mindist
    maxdist = np.inf if args.maxdist is None else args.maxdist

    if args.rescale and args.rescale_size % 2 == 0:
        raise ValueError("Please provide an odd rescale_size")
    rescale_flank = args.rescale_flank if args.rescale else None

    if args.by_window:
        if features_format != "bed":
            raise ValueError(
                "Can't make by-window pileups without making combinations"
            )
        if args.local:
            raise ValueError("Can't make local by-window pileups")

    pups = pileup(
        clr=clr,
        features=features,
        features_format=features_format,
        view_df=view_df,
        expected_df=expected,
        expected_value_col=expected_value_col,
        clr_weight_name=args.clr_weight_name,
        flank=args.flank,
        minshift=args.minshift,
        maxshift=args.maxshift,
        nshifts=args.nshifts,
        ooe=args.ooe,
        mindist=mindist,
        maxdist=maxdist,
        min_diag=args.ignore_diags,
        subset=args.subset,
        by_window=args.by_window,
        by_strand=args.by_strand,
        by_distance=distance_edges,
        groupby=[] if args.groupby is None else args.groupby,
        ignore_group_order=ignore_group_order,
        flip_negative_strand=args.flip_negative_strand,
        local=args.local,
        coverage_norm=args.coverage_norm,
        trans=args.trans,
        rescale=args.rescale,
        rescale_flank=rescale_flank,
        rescale_size=args.rescale_size,
        store_stripes=args.store_stripes,
        nproc=nproc,
        seed=args.seed,
        device=args.device,
    )

    if args.outname == "auto":
        # auto-name encodes the run parameters (reference CLI.py:567–595)
        outname = f"{coolname}-{clr.binsize / 1000}K_over_{bedname}"
        if args.nshifts > 0 and args.expected is None:
            outname += f"_{args.nshifts}-shifts"
        if args.expected is not None:
            outname += "_expected"
        if args.nshifts <= 0 and args.expected is None:
            outname += "_noNorm"
        if args.local:
            outname += "_local"
        elif args.mindist is not None or args.maxdist is not None:
            outname += f"_dist_{mindist}-{maxdist}"
        if args.rescale:
            outname += "_rescaled"
        if args.coverage_norm:
            outname += "_covnorm"
        if args.subset > 0:
            outname += f"_subset-{args.subset}"
        if args.by_window:
            outname += "_by-window"
        if args.by_strand:
            outname += "_by-strand"
        if args.trans:
            outname += "_trans"
        if args.groupby:
            outname += f"_by-{'_'.join(args.groupby)}"
        outname += ".clpy"
    else:
        outname = args.outname

    if args.expected:
        pups["expected_file"] = expected_path
    if args.view:
        pups["view_file"] = args.view
    pups["features"] = args.features
    return pups, outname


def main(argv=None):
    parser = parse_args_coolpuppy()
    args = parser.parse_args(argv)

    if args.post_mortem:

        def _excepthook(exc_type, value, tb):
            traceback.print_exception(exc_type, value, tb)
            print()
            pdb.pm()

        sys.excepthook = _excepthook

    logging.basicConfig(level=getattr(logging, args.logLevel))
    logger.setLevel(getattr(logging, args.logLevel))
    logger.debug(args)

    clr = Cooler(args.cool_path)
    pups, outname = pileup_from_args(args, clr)
    save_pileup_df(outname, pups)
    logger.info(f"Saved output to {outname}")
    return outname


if __name__ == "__main__":
    main()
