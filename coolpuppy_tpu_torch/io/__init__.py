"""File formats of the port: the ``.cool`` reader (a file, or arrays in
memory), BED/BEDPE/expected tables, ``.clpy`` pileups, ``.txt`` arrays and
the ``.cool`` writer (counterpart of ``coolpuppy_tpu/io``). h5py is imported
only inside the functions that read or write HDF5 files, so the package
imports without it."""

from .cool import Cooler, PixelSlab  # noqa: F401
from .coolwrite import write_cool  # noqa: F401
from .bedio import (  # noqa: F401
    read_table,
    read_viewframe_from_file,
    read_expected_from_file,
    sniff_for_header,
    is_gz_file,
    validate_csv,
)
from .clpy import (  # noqa: F401
    save_pileup_df,
    load_pileup_df,
    load_pileup_df_list,
)
from .txt import save_array_with_header, load_array_with_header  # noqa: F401
