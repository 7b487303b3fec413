"""BED/BEDPE/expected table ingestion (counterpart of
``coolpuppy_tpu/io/bedio.py``).

Replaces the bioframe.read_table / cooltools.lib.io read_viewframe /
read_expected surface used by the reference CLI (reference CLI.py:406–508) and
the header sniffing of reference lib/io.py:242–278.
"""

from __future__ import annotations

import csv
import gzip
import io as _io
import os.path as op

import numpy as np
import pandas as pd

from ..genomics.intervals import make_viewframe, is_valid_expected

BED_SCHEMA = ["chrom", "start", "end", "name", "score", "strand"]
BEDPE_SCHEMA = [
    "chrom1",
    "start1",
    "end1",
    "chrom2",
    "start2",
    "end2",
    "name",
    "score",
    "strand1",
    "strand2",
]


def is_gz_file(filepath):
    with open(filepath, "rb") as test_f:
        return test_f.read(2) == b"\x1f\x8b"


def sniff_for_header(file, sep="\t", comment="#"):
    """Detect whether a table file has a header line; returns
    (buffer, names, ncols). Mirrors reference lib/io.py:247–278."""
    if isinstance(file, str):
        if is_gz_file(file):
            with gzip.open(file, "rt") as f:
                buf = _io.StringIO(f.read())
        else:
            with open(file, "r") as f:
                buf = _io.StringIO(f.read())
    else:
        buf = _io.StringIO(file.read())

    sample_lines = []
    for line in buf:
        if not line.startswith(comment):
            sample_lines.append(line)
            break
    for _ in range(10):
        sample_lines.append(buf.readline())
    buf.seek(0)

    try:
        has_header = csv.Sniffer().has_header("\n".join(sample_lines))
    except csv.Error:
        has_header = False
    if has_header:
        names = sample_lines[0].strip().split(sep)
    else:
        names = None
    ncols = len(sample_lines[0].strip().split(sep))
    return buf, names, ncols


def read_table(path_or_buf, schema=None, names=None, sep="\t", comment="#"):
    """Read a BED-like table (bioframe.read_table counterpart).

    ``schema`` may be 'bed', 'bed3'..'bed6', 'bedpe'; or pass explicit
    ``names``.
    """
    if schema is not None and names is None:
        if schema.startswith("bedpe"):
            names = BEDPE_SCHEMA[:6] if schema == "bedpe6" else BEDPE_SCHEMA
        elif schema.startswith("bed"):
            n = int(schema[3:]) if len(schema) > 3 else 6
            names = BED_SCHEMA[:n]
        else:
            raise ValueError(f"unknown schema {schema}")
    df = pd.read_csv(
        path_or_buf,
        sep=sep,
        comment=comment,
        header=None,
        names=names,
        usecols=range(len(names)) if names else None,
    )
    for col in df.columns:
        if str(col).startswith("chrom") or str(col).startswith("strand"):
            df[col] = df[col].astype(str)
    return df


def read_features(path, features_format="auto", dedup_anchors=False):
    """Read a features file with header auto-detection, like the reference CLI
    (reference CLI.py:406–475). Returns (DataFrame, resolved_format)."""
    buf, names, ncols = sniff_for_header(path)
    if names is not None:
        df = pd.read_csv(buf, sep="\t", comment="#")
        if features_format == "auto":
            if {"chrom1", "start1", "end1", "chrom2", "start2", "end2"}.issubset(
                df.columns
            ):
                features_format = "bedpe"
            elif {"chrom", "start", "end"}.issubset(df.columns):
                features_format = "bed"
            else:
                raise ValueError("cannot determine features format from header")
    else:
        if features_format == "auto":
            features_format = "bedpe" if ncols >= 6 else "bed"
        schema = BEDPE_SCHEMA if features_format == "bedpe" else BED_SCHEMA
        df = pd.read_csv(
            buf, sep="\t", comment="#", header=None, names=schema[:ncols]
        )
    for col in df.columns:
        if str(col).startswith("chrom") or str(col).startswith("strand"):
            df[col] = df[col].astype(str)
    return df, features_format


def read_viewframe_from_file(path, verify_cooler=None):
    """Read a 3/4-column BED as a viewframe (cooltools.lib.io counterpart,
    reference CLI.py:477–482)."""
    buf, names, ncols = sniff_for_header(path)
    if names is not None:
        df = pd.read_csv(buf, sep="\t", comment="#")
    else:
        df = pd.read_csv(
            buf,
            sep="\t",
            comment="#",
            header=None,
            names=["chrom", "start", "end", "name"][:ncols],
        )
    bounds = verify_cooler.chromsizes if verify_cooler is not None else None
    return make_viewframe(df, check_bounds=bounds)


def read_expected_from_file(
    path,
    expected_value_cols=("balanced.avg",),
    verify_view=None,
    verify_cooler=None,
):
    """Read a cis or trans expected tsv (cooltools.lib.io counterpart,
    reference CLI.py:484–508)."""
    df = pd.read_csv(path, sep="\t", comment="#")
    kind = "cis" if "dist" in df.columns else "trans"
    is_valid_expected(
        df,
        kind,
        view_df=verify_view,
        verify_cooler=verify_cooler,
        expected_value_cols=list(expected_value_cols),
        raise_errors=True,
    )
    for col in expected_value_cols:
        df[col] = pd.to_numeric(df[col], errors="coerce")
    return df


def validate_csv(value, default_column="balanced.avg"):
    """Parse the ``path::column`` convention for --expected
    (reference lib/util.py:4–14)."""
    if value is None:
        return
    file_path, _, field_name = value.partition("::")
    if not op.exists(file_path):
        raise ValueError(f"Path not found: {file_path}")
    if not field_name:
        field_name = default_column
    elif field_name.isdigit():
        field_name = int(field_name)
    return file_path, field_name
