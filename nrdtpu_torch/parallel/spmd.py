"""The frame's planes as a rank's rows - counterpart of `nrdtpu/parallel/spmd.py`.

The JAX Engine places every (h, w[, c]) plane row-sharded and jits the unchanged frame, and
GSPMD inserts the exchanges. The port runs one process a rank: each rank takes its rows of the
frame's planes here, and the passes exchange rows by hand (`sharding.shard_stencil`,
`sharding.gather_rows`). The 1/16-resolution tile maps are not sliced: the passes build them
from gathered planes, since a band need not be a multiple of 16 rows.
"""

from __future__ import annotations

from .sharding import rows


def shard_frame_tree(mesh, tree: dict, h: int, w: int) -> dict:
    """This rank's rows of every plane of a dict whose leading dims are the frame's (h, w)
    (numpy arrays or tensors); a plane that already has the band's height and the frame's
    width is taken as this rank's rows; anything else is left whole."""
    row0, row1 = rows(h, mesh)

    def place(leaf):
        shape = getattr(leaf, "shape", ())
        if len(shape) >= 2 and shape[1] == w and shape[0] == h:
            return leaf[row0:row1]
        return leaf

    return {k: place(v) for k, v in tree.items()}
