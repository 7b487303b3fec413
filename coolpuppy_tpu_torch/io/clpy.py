""".clpy pileup storage (HDF5).

Same on-disk concept as reference lib/io.py:18–190: a `data` dataset of
vertically stacked W×W pileups, per-row sparse CSR stripe groups in the
h5sparse layout (`data`/`indices`/`indptr` + h5sparse attrs), `coordinates_i`
string datasets, and an `attrs` group with run metadata. The annotation table
is stored as a JSON dataset (`annotation_json`) rather than pandas.to_hdf,
since PyTables is not a dependency of this build. Counterpart of
``coolpuppy_tpu/io/clpy.py``: files written by either package load in the
other. h5py and scipy are imported inside the functions that need them.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pandas as pd

from .._version import __version__

ARRAY_COLS = ["data", "vertical_stripe", "horizontal_stripe", "coordinates"]
_TUPLE_COLS = {"distance_band", "group"}


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        v = float(v)
    if isinstance(v, float):
        if np.isnan(v):
            return {"__float__": "nan"}
        if np.isinf(v):
            return {"__float__": "inf" if v > 0 else "-inf"}
        return v
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist()}
    if isinstance(v, tuple):
        return {"__tuple__": [_jsonable(x) for x in v]}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    return v


def _unjsonable(v, col=None):
    if isinstance(v, dict):
        if "__tuple__" in v:
            return tuple(_unjsonable(x) for x in v["__tuple__"])
        if "__ndarray__" in v:
            return np.asarray(v["__ndarray__"])
        if "__float__" in v:
            return float(v["__float__"])
    if isinstance(v, list):
        out = [_unjsonable(x) for x in v]
        return tuple(out) if col in _TUPLE_COLS else out
    return v


def _write_csr(f, name, arr, compression):
    """Write a 2D array as CSR in the h5sparse group layout."""
    from scipy import sparse as sp

    m = sp.csr_matrix(np.asarray(arr, dtype=np.float64))
    g = f.create_group(name)
    g.attrs["h5sparse_format"] = "csr"
    g.attrs["h5sparse_shape"] = np.asarray(m.shape, dtype=np.int64)
    g.create_dataset("data", data=m.data, compression=compression)
    g.create_dataset("indices", data=m.indices, compression=compression)
    g.create_dataset("indptr", data=m.indptr, compression=compression)


def _read_csr(g):
    from scipy import sparse as sp

    shape = tuple(int(x) for x in g.attrs["h5sparse_shape"])
    return sp.csr_matrix(
        (g["data"][:], g["indices"][:], g["indptr"][:]), shape=shape
    ).toarray()


def save_pileup_df(filename, df, metadata=None, mode="w", compression="lzf"):
    """Save a pileup DataFrame (reference lib/io.py:18–95 counterpart).

    `None` metadata values are replaced with `False` (HDF5 has no null)."""
    import h5py

    if metadata is None:
        metadata = {}
    df = df.reset_index(drop=True)

    ann_cols = [c for c in df.columns if c not in ARRAY_COLS]
    records = []
    for _, row in df[ann_cols].iterrows():
        records.append({c: _jsonable(row[c]) for c in ann_cols})

    with h5py.File(filename, mode if mode in ("w", "x") else "a") as f:
        f.create_dataset(
            "annotation_json",
            data=json.dumps({"columns": ann_cols, "records": records}),
        )
        # reference-compatible annotation table (pandas fixed format, what
        # the reference's pd.read_hdf(.., "annotation") expects — reference
        # lib/io.py:30–53)
        from .pandas_hdf import write_fixed_frame

        write_fixed_frame(f, "annotation", df[ann_cols])
        width = int(df["data"].iloc[0].shape[0])
        height = width * df.shape[0]
        ds = f.create_dataset(
            "data",
            compression=compression,
            chunks=(width, width),
            shape=(height, width),
            dtype=np.float64,
        )
        for i, arr in df["data"].reset_index(drop=True).items():
            ds[i * width : (i + 1) * width, :] = arr
        if "store_stripes" in df.columns and df["store_stripes"].any():
            for i, arr in df["vertical_stripe"].reset_index(drop=True).items():
                _write_csr(f, f"vertical_stripe_{i}", arr, compression)
            for i, arr in df["horizontal_stripe"].reset_index(drop=True).items():
                _write_csr(f, f"horizontal_stripe_{i}", arr, compression)
            for i, arr in df["coordinates"].reset_index(drop=True).items():
                coords = np.asarray(arr, dtype=object)
                f.create_dataset(
                    f"coordinates_{i}",
                    shape=(len(arr), 6),
                    data=coords.astype(h5py.string_dtype()),
                    compression=compression,
                )
        group = f.create_group("attrs")
        for key, val in metadata.items():
            if val is None:
                val = False
            group.attrs[key] = val
        group.attrs["version"] = __version__


def load_pileup_df(filename, quaich=False, skipstripes=False):
    """Load a .clpy file (reference lib/io.py:98–156 counterpart)."""
    import h5py

    with h5py.File(filename, "r") as f:
        metadata = dict(f["attrs"].attrs)
        if "annotation_json" in f:
            payload = json.loads(f["annotation_json"][()])
            records = [
                {c: _unjsonable(rec.get(c), col=c) for c in payload["columns"]}
                for rec in payload["records"]
            ]
            annotation = pd.DataFrame(records, columns=payload["columns"])
        else:
            # reference-written file: pandas fixed-format annotation table
            from .pandas_hdf import read_fixed_frame

            annotation = read_fixed_frame(f, "annotation").reset_index(
                drop=True
            )
        n = len(annotation)
        dstore = f["data"]
        width = dstore.shape[1]
        data = [dstore[i * width : (i + 1) * width, :] for i in range(n)]
        annotation["data"] = data
        if not skipstripes and "vertical_stripe_0" in f:
            vertical, horizontal, coordinates = [], [], []
            for i in range(n):
                vertical.append(_read_csr(f[f"vertical_stripe_{i}"]))
                horizontal.append(_read_csr(f[f"horizontal_stripe_{i}"]))
                coords = f[f"coordinates_{i}"][:]
                coordinates.append(
                    np.array(
                        [[x.decode() if isinstance(x, bytes) else str(x) for x in row] for row in coords]
                    )
                )
            annotation["vertical_stripe"] = vertical
            annotation["horizontal_stripe"] = horizontal
            annotation["coordinates"] = coordinates
    for key, val in metadata.items():
        if key != "version":
            annotation[key] = [val] * len(annotation)
    if quaich:
        basename = os.path.basename(filename)
        sample, bedname = re.search(
            r"^(.*)-(?:[0-9]+)_over_(.*)_(?:[0-9]+-shifts|expected).*\.clpy", basename
        ).groups()
        annotation["sample"] = sample
        annotation["bedname"] = bedname
    return annotation


def load_pileup_df_list(files, quaich=False, nice_metadata=True, skipstripes=False):
    """Load and concat many .clpy files; optionally add the 'norm' column
    (reference lib/io.py:159–190)."""
    pups = pd.concat(
        [load_pileup_df(path, quaich=quaich, skipstripes=skipstripes) for path in files]
    ).reset_index(drop=True)
    if nice_metadata:
        expected = pups["expected"].fillna(False).astype(bool)
        pups["norm"] = np.where(expected, "expected", "shifts").astype(str)
        pups.loc[
            ~((pups["nshifts"] > 0) | expected), "norm"
        ] = "none"
    return pups
