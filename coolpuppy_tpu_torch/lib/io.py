"""The reference's ``lib.io`` names (counterpart of ``coolpuppy/lib/io.py``):
``.clpy`` and ``.txt`` files and two of the BED readers' helpers."""

from ..io.bedio import is_gz_file, sniff_for_header  # noqa: F401
from ..io.clpy import (  # noqa: F401
    load_pileup_df,
    load_pileup_df_list,
    save_pileup_df,
)
from ..io.txt import (  # noqa: F401
    load_array_with_header,
    save_array_with_header,
)
