"""Legacy text pileup format: np.savetxt array + '# '-commented YAML-ish header
(counterpart of ``coolpuppy_tpu/io/txt.py``; reference lib/io.py:193–239). PyYAML is not a dependency; we emit/parse the
flat subset of YAML the reference headers actually use (scalars, lists,
null/bool), which round-trips the reference's own golden files
(reference tests/loop_ref.np.txt:1–33)."""

from __future__ import annotations

import io as _io

import numpy as np


def _dump_scalar(v):
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer, float, np.floating)):
        if isinstance(v, (float, np.floating)) and (np.isinf(v) or np.isnan(v)):
            return ".inf" if np.isinf(v) and v > 0 else ("-.inf" if np.isinf(v) else ".nan")
        return repr(v) if not isinstance(v, (np.integer, np.floating)) else repr(v.item())
    s = str(v)
    if s == "" or any(ch in s for ch in ":#{}[],&*!|>'\"%@`") or s != s.strip():
        return "'" + s.replace("'", "''") + "'"
    return s


def dump_yaml(d):
    lines = []
    for k, v in d.items():
        if isinstance(v, (list, tuple, np.ndarray)):
            lines.append(f"{k}:")
            for item in list(v):
                lines.append(f"- {_dump_scalar(item)}")
        else:
            lines.append(f"{k}: {_dump_scalar(v)}")
    return "\n".join(lines)


def _parse_scalar(s):
    s = s.strip()
    if s.startswith("'") and s.endswith("'"):
        return s[1:-1].replace("''", "'")
    if s.startswith('"') and s.endswith('"'):
        return s[1:-1]
    low = s.lower()
    if low in ("null", "~", "none", ""):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    if low == ".inf":
        return np.inf
    if low == "-.inf":
        return -np.inf
    if low == ".nan":
        return np.nan
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def load_yaml(text):
    out = {}
    key = None
    for line in text.split("\n"):
        if not line.strip():
            continue
        if line.lstrip().startswith("- "):
            if key is None:
                continue
            if not isinstance(out.get(key), list):
                out[key] = []
            out[key].append(_parse_scalar(line.lstrip()[2:]))
        elif ":" in line:
            key, _, val = line.partition(":")
            key = key.strip()
            val = val.strip()
            out[key] = _parse_scalar(val) if val else None
    return out


def save_array_with_header(array, header, filename):
    """Save a numpy array with a YAML header (reference lib/io.py:193–207)."""
    np.savetxt(filename, array, header=dump_yaml(header).strip())


def load_array_with_header(filename):
    """Load files produced by save_array_with_header (or the reference's
    golden outputs); returns metadata dict with 'data' (reference
    lib/io.py:210–239)."""
    with open(filename) as f:
        read_data = f.read()
    lines = read_data.split("\n")
    header = "\n".join(line[2:] for line in lines if line.startswith("# "))
    metadata = load_yaml(header) if header else {}
    data = "\n".join(line for line in lines if not line.startswith("# "))
    with _io.StringIO(data) as f:
        metadata["data"] = np.loadtxt(f)
    return metadata
