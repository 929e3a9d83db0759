"""Row sharding of a frame over a `torch.distributed` group - counterpart of
`nrdtpu/parallel/sharding.py`.

One process a rank; rank r of n holds the frame rows [r h / n, (r + 1) h / n) of every image
plane. A pass with a stencil runs on its rank's rows plus `halo` rows above and below
(`shard_stencil`), at the padded plane's row origin, so that what the pass derives from a pixel
index (uv, in-screen tests, hashes) stays the frame's; rows beyond the frame are edge-replicated,
as clamp addressing reads them. This build exchanges rows with one all-gather of the plane, then
a slice (`halo_rows`), which also serves a halo taller than a rank's band; the reprojection
passes read the previous frame's planes whole (`gather_rows`), as GSPMD's all-gathers do.

Backends: "nccl" where each rank has its own card, "gloo" on the CPU and for several ranks on
one card. With gloo a card's tensor is staged through host memory around each collective
(`gather_rows`). Every collective moves raw bytes (a uint8 view), so bfloat16 planes need no
support of their own in the backend.

`mesh=None` means unsharded: `shard_stencil` calls the pass on the whole planes at row 0 and
`gather_rows` returns its input.
"""

from __future__ import annotations

import inspect
import math
import sys
from dataclasses import dataclass

import torch
import torch.distributed as dist

# bytes this process received through `gather_rows` (reset by the caller)
exchanged_bytes = 0


@dataclass(frozen=True)
class RowMesh:
    """A process group whose ranks hold bands of rows; `device` is this rank's."""

    group: object  # the torch.distributed group (None: the default group)
    rank: int
    size: int
    device: torch.device
    backend: str


def make_mesh(group=None, device=None) -> RowMesh:
    """The RowMesh of an initialized torch.distributed group (the default group if None), on
    `device` (default: cuda:{rank % device_count} under nccl, else the CPU). Raises if no group
    is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no torch.distributed group is initialized (call "
                           "torch.distributed.init_process_group, or use parallel.launch.spawn)")
    backend = str(dist.get_backend(group))
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        device = (f"cuda:{rank % torch.cuda.device_count()}" if backend == "nccl" else "cpu")
    return RowMesh(group, rank, size, torch.device(device), backend)


def rows(h: int, mesh) -> tuple:
    """(row0, row1): this rank's frame rows of a frame h high; (0, h) unsharded."""
    if mesh is None:
        return 0, h
    if h % mesh.size:
        raise ValueError(f"a frame {h} rows high does not split into {mesh.size} equal bands "
                         "(uneven shards are not supported: ROADMAP.md)")
    band = h // mesh.size
    return mesh.rank * band, (mesh.rank + 1) * band


def gather_rows(x, mesh):
    """The whole frame of a plane whose rows are sharded: every rank's band, in rank order."""
    global exchanged_bytes
    if mesh is None or mesh.size == 1:
        return x
    src = x.contiguous()
    staged = mesh.backend == "gloo" and src.device.type == "cuda"
    if staged:  # gloo's collectives take host tensors
        src = src.cpu()
    raw = src.view(torch.uint8) if src.dim() else src.reshape(1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.size)]
    dist.all_gather(parts, raw, group=mesh.group)
    exchanged_bytes += raw.numel() * (mesh.size - 1)
    out = torch.cat(parts, 0)
    if staged:
        out = out.to(x.device)
    return out.view(x.dtype)


def from_rank0(value, mesh):
    """Rank 0's value of a host float (or None) on every rank; `value` unchanged unsharded.
    Every rank calls it at the same point of its frame."""
    if mesh is None or mesh.size == 1:
        return value
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([math.nan if value is None else float(value)], dtype=torch.float64,
                     device=dev)
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast(t, src=src, group=mesh.group)
    out = float(t.item())
    return None if math.isnan(out) else out


def clamped_rows(x, first: int, count: int, dim: int = 0):
    """Rows first .. first + count - 1 of x along `dim`, those beyond its edges
    edge-replicated (clamp addressing)."""
    idx = torch.clamp(torch.arange(first, first + count, device=x.device), 0, x.shape[dim] - 1)
    return x.index_select(dim, idx).contiguous()


def halo_rows(x, halo: int, mesh):
    """(padded, origin): this rank's rows of x with `halo` rows above and below, rows beyond
    the frame edge-replicated, and the frame row of the padded plane's first row. Any halo
    works, a taller one than the band too (its rows come from several ranks)."""
    h = x.shape[0]
    row0 = 0 if mesh is None else mesh.rank * h
    return clamped_rows(gather_rows(x, mesh), row0 - halo, h + 2 * halo), row0 - halo


def band_call(fn, args, kwargs, row0: int, rows: int, halo: int, frame_h: int):
    """The arguments of a whole-frame call fn(*args, **kwargs) of a row-origin kernel wrapper
    (one whose module names its previous-frame arguments in `PREVIOUS_PLANES`) for the band of
    frame rows row0 .. row0 + rows - 1 with `halo` rows above and below, as `halo_rows` pads
    it: every current plane ((frame_h, ...) or a (planes, frame_h, w) stack) cut to the padded
    rows, the previous planes whole, and the row origin where fn takes one."""
    previous = sys.modules[fn.__module__].PREVIOUS_PLANES
    sig = inspect.signature(fn)
    bound = sig.bind(*args, **kwargs)

    def cut(t):
        if isinstance(t, torch.Tensor) and t.dim() >= 2 and t.shape[0] == frame_h:
            return clamped_rows(t, row0 - halo, rows + 2 * halo)
        if isinstance(t, torch.Tensor) and t.dim() == 3 and t.shape[1] == frame_h:
            return clamped_rows(t, row0 - halo, rows + 2 * halo, dim=1)
        return t

    for name, value in bound.arguments.items():
        if name not in previous:
            bound.arguments[name] = cut(value)
    if "row0" in sig.parameters:
        bound.arguments.update(row0=row0 - halo, frame_h=frame_h)
    return bound.args, bound.kwargs


def halo_table(rows: dict, override=None) -> dict:
    """A denoiser's halo a pass (`rows`: pass -> rows of its reach) with `override`, a dict of
    passes to counts, applied."""
    if override is None:
        return dict(rows)
    unknown = set(override) - set(rows)
    if unknown:
        raise ValueError(f"halo_override: no pass {sorted(unknown)}; the passes are {list(rows)}")
    return {**rows, **override}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_stencil(mesh, fn, halo: int, tree, h: int):
    """Run one pass of a row-sharded frame h rows high (`nrdtpu/parallel/sharding.py:88-128`):
    every image leaf of `tree` (a tensor of this rank's h // n rows) is halo-padded, then
    `fn(padded_tree, row0)` runs with row0 the frame row of the padded planes' first row, and
    every tensor of its result (a tensor, or a dict / tuple / list of them) with the padded
    height is cropped back to this rank's rows. Unsharded (mesh None): fn(tree, 0) on the whole
    planes, its result as it is."""
    if mesh is None:
        return fn(tree, 0)
    row0, row1 = rows(h, mesh)
    band = row1 - row0
    origin = [row0 - halo]

    def pad(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 and leaf.shape[0] == band:
            padded, origin[0] = halo_rows(leaf, halo, mesh)
            return padded
        return leaf

    out = fn(_map(tree, pad), origin[0])
    padded_h = band + 2 * halo
    return _map(out, lambda t: t[halo:halo + band].contiguous()
                if isinstance(t, torch.Tensor) and t.dim() >= 1 and t.shape[0] == padded_h
                else t)
