"""``by_strand``: the group of a window is its two anchors' strands, left
then right (``++``, ``+-``, ``-+``, ``--``)."""

import numpy as np


def keys(job, left, right):
    return np.char.add(left["strand"].astype(str),
                       right["strand"].astype(str))
