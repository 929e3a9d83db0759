"""Multi-rank execution of the port - counterpart of `nrdtpu/parallel/`: frames row-sharded
over a `torch.distributed` group, one process a rank (`launch.spawn`), each holding a band of
rows (`sharding`, `spmd`)."""

from .sharding import RowMesh, gather_rows, halo_rows, make_mesh, rows, shard_stencil  # noqa: F401
from .spmd import shard_frame_tree  # noqa: F401
