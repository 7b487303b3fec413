"""Reader/writer for the pandas-HDF5 "fixed" frame layout on raw h5py.

The reference stores the .clpy annotation table via ``df.to_hdf(path,
key="annotation")`` (reference lib/io.py:30–53), which is the PyTables-backed
pandas *fixed* format. PyTables is not available in this build, so the layout
is implemented directly with h5py (counterpart of
``coolpuppy_tpu/io/pandas_hdf.py``; h5py is imported inside the functions that
need it, so the package imports without it):

  /<key>                      group; attrs pandas_type=b"frame",
                              pandas_version, encoding, ndim, nblocks,
                              axis{0,1}_variety=b"regular"
  /<key>/axis0                column names (fixed-width bytes, kind=b"string")
  /<key>/axis1                row index    (int64, kind=b"integer")
  /<key>/block<i>_items       the i-th block's column names
  /<key>/block<i>_values      the block's values, shape (n_block_cols, n_rows)
                              with transposed=True; OBJECT blocks are a
                              PyTables VLArray of ONE row holding the pickled
                              2D object ndarray (PSEUDOATOM=b"object"), which
                              is what pandas emits for object dtypes in fixed
                              format

The reader is lenient (handles any block split / attr spelling pandas
produced); the writer emits numeric blocks as plain arrays and everything
else as one pickled object block — a layout pandas.read_hdf reassembles
generically. Round-trip tested here; cross-read with real PyTables is
covered by a test gated on ``tables`` availability.
"""

from __future__ import annotations

import pickle

import numpy as np
import pandas as pd

_PANDAS_VERSION = b"0.15.2"  # the format version pandas stamps, not pandas's


def _bytes_attr(v):
    if isinstance(v, bytes):
        return v
    return str(v).encode()


def _set_array_attrs(ds, kind=None, transposed=None, name=None):
    ds.attrs["CLASS"] = np.bytes_(b"ARRAY")
    ds.attrs["FLAVOR"] = np.bytes_(b"numpy")
    ds.attrs["TITLE"] = np.bytes_(b"")
    ds.attrs["VERSION"] = np.bytes_(b"2.4")
    if kind is not None:
        ds.attrs["kind"] = np.bytes_(_bytes_attr(kind))
    if name is not None:
        ds.attrs["name"] = np.bytes_(_bytes_attr(name))
    if transposed is not None:
        ds.attrs["transposed"] = np.bool_(transposed)


def _write_object_block(group, key, values_2d):
    """One-row VLArray of pickled ndarray — PyTables ObjectAtom layout."""
    import h5py

    payload = np.frombuffer(
        pickle.dumps(np.asarray(values_2d, dtype=object), protocol=2),
        dtype=np.uint8,
    )
    ds = group.create_dataset(
        key, shape=(1,), dtype=h5py.vlen_dtype(np.uint8)
    )
    ds[0] = payload
    ds.attrs["CLASS"] = np.bytes_(b"VLARRAY")
    ds.attrs["PSEUDOATOM"] = np.bytes_(b"object")
    ds.attrs["TITLE"] = np.bytes_(b"")
    ds.attrs["VERSION"] = np.bytes_(b"1.4")
    ds.attrs["transposed"] = np.bool_(True)


def _write_items(group, key, names):
    arr = np.asarray([str(n) for n in names], dtype="S")
    ds = group.create_dataset(key, data=arr)
    _set_array_attrs(ds, kind="string", transposed=False, name="N.")


def write_fixed_frame(f, key, df):
    """Write ``df`` under ``f[key]`` in the pandas fixed-frame layout."""
    df = df.reset_index(drop=True)
    group = f.create_group(key)
    group.attrs["CLASS"] = np.bytes_(b"GROUP")
    group.attrs["TITLE"] = np.bytes_(b"")
    group.attrs["VERSION"] = np.bytes_(b"1.0")
    group.attrs["pandas_type"] = np.bytes_(b"frame")
    group.attrs["pandas_version"] = np.bytes_(_PANDAS_VERSION)
    group.attrs["encoding"] = np.bytes_(b"UTF-8")
    group.attrs["errors"] = np.bytes_(b"strict")
    group.attrs["ndim"] = np.int64(2)
    group.attrs["axis0_variety"] = np.bytes_(b"regular")
    group.attrs["axis1_variety"] = np.bytes_(b"regular")

    _write_items(group, "axis0", df.columns)
    ax1 = group.create_dataset(
        "axis1", data=np.arange(len(df), dtype=np.int64)
    )
    _set_array_attrs(ax1, kind="integer", transposed=False, name="None")

    # numeric blocks by dtype; everything else in one pickled object block
    blocks = []  # (columns, values (n_cols, n_rows), is_object)
    float_cols = [c for c in df.columns if df[c].dtype.kind == "f"]
    int_cols = [c for c in df.columns if df[c].dtype.kind in "iu"]
    other_cols = [
        c for c in df.columns if c not in float_cols and c not in int_cols
    ]
    if float_cols:
        blocks.append(
            (float_cols, df[float_cols].to_numpy(np.float64).T, False)
        )
    if int_cols:
        blocks.append((int_cols, df[int_cols].to_numpy(np.int64).T, False))
    if other_cols:
        vals = np.empty((len(other_cols), len(df)), dtype=object)
        for i, c in enumerate(other_cols):
            vals[i, :] = list(df[c])
        blocks.append((other_cols, vals, True))

    group.attrs["nblocks"] = np.int64(len(blocks))
    for i, (cols, vals, is_object) in enumerate(blocks):
        _write_items(group, f"block{i}_items", cols)
        if is_object:
            _write_object_block(group, f"block{i}_values", vals)
        else:
            ds = group.create_dataset(f"block{i}_values", data=vals)
            _set_array_attrs(ds, transposed=True)


def _decode(x):
    if isinstance(x, bytes):
        return x.decode()
    return x


def _read_values(ds):
    """Block values: unpickle PyTables object VLArrays, else plain array."""
    import h5py

    if h5py.check_vlen_dtype(ds.dtype) is not None or (
        _decode(ds.attrs.get("CLASS", b"")) == "VLARRAY"
    ):
        raw = ds[0]
        return pickle.loads(np.asarray(raw, dtype=np.uint8).tobytes())
    vals = ds[:]
    if vals.dtype.kind == "S":
        vals = vals.astype(str)
    return vals


def read_fixed_frame(f, key):
    """Read a pandas fixed-format frame written by pandas/PyTables (or by
    write_fixed_frame) into a DataFrame."""
    group = f[key]
    if _decode(group.attrs.get("pandas_type", b"")) != "frame":
        raise ValueError(f"{key} is not a pandas fixed-format frame")
    columns = [_decode(c) for c in group["axis0"][:]]
    index = group["axis1"][:]
    nblocks = int(group.attrs["nblocks"])
    data = {}
    for i in range(nblocks):
        items = [_decode(c) for c in group[f"block{i}_items"][:]]
        vals = _read_values(group[f"block{i}_values"])
        vals = np.asarray(vals)
        if vals.ndim == 1:
            vals = vals.reshape(1, -1)
        for j, col in enumerate(items):
            data[col] = vals[j, :]
    frame = pd.DataFrame({c: data[c] for c in columns if c in data})
    frame.index = index
    return frame
