"""Launch a row-sharded run: one process a rank on this host (the JAX package needs no
launcher: one process drives all its devices).

    from nrdtpu_torch.parallel import launch
    results = launch.spawn(launch.run_engine_ranks, 4, "gloo", "cuda", cases)

`spawn` starts `world` processes (start method "spawn"), each of which initializes a
`torch.distributed` group over TCP on 127.0.0.1, builds its `RowMesh` on its device
(cuda:{rank % device_count} or the CPU), calls `fn(mesh, *args)` and returns rank 0's result.
The backend is the caller's, or by the rank layout: "nccl" where every rank has a card of its
own, else "gloo" (the CPU, or several ranks sharing a card); it is printed. A rank that raises or
dies fails the call. The kernel library is built by the caller before the ranks start
(`kernels.build.library`, under a lock); the ranks load it.

`run_engine_ranks` is the ranks' target of the tests and `chip_smoke.py`: the port's Engine over
frames of the seeded orbit scene (`utils.scene`), or of frames saved with `save_frames`, on
every rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import pickle
import queue
import socket
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import sharding


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(world: int, device: str) -> str:
    """nccl where each rank has a card of its own, else gloo."""
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, world, backend, device, port, results, threads, timeout, args):
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        if device == "cuda":
            dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        torch.set_num_threads(threads)
        out = fn(sharding.make_mesh(device=dev), *args)
        dist.barrier()
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend, device: str, *args, threads: int = 1, timeout: float = 900.0):
    """Run fn(mesh, *args) on `world` ranks of a fresh group; returns rank 0's result. fn must
    be importable by the ranks (a module-level function of this package, so that a rank
    imports nothing else); backend None picks it by the rank layout (`default_backend`);
    device "cuda" or "cpu"; threads: torch's intra-op threads a rank; timeout: seconds for the
    whole run (and for each collective), after which the ranks are ended and it raises."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    backend = backend or default_backend(world, device)
    print(f"parallel.launch: {world} rank(s) on {device}, backend {backend}", flush=True)
    if device == "cuda":
        from ..kernels import build

        build.library()  # built here once; the ranks load it
        # ranks on the caller's card need the memory that its allocator holds unused
        gc.collect()
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(fn, world, backend, device, free_port(),
                                                 results, threads, timeout, args),
                               nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    out, got = None, False
    try:
        while not got:
            try:
                out, got = results.get(timeout=0.5), True
            except queue.Empty:
                if procs.join(timeout=0):  # every rank ended, none gave a result
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"parallel.launch: the ranks ran past {timeout} s")
        while not procs.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"parallel.launch: the ranks ran past {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    if not got:
        raise RuntimeError("parallel.launch: rank 0 returned no result")
    return out


# ---------------------------------------------------------------------------------------------
# The Engine on every rank
# ---------------------------------------------------------------------------------------------


def scene_pool(denoiser, gen, fd) -> dict:
    """The input pool of a frame of the orbit scene for REFERENCE, SIGMA_SHADOW or
    REBLUR_DIFFUSE (the pools of `tests/test_sharding.py:36-57`, by the port's frontend)."""
    from .. import frontend as fe
    from ..settings import Denoiser, ResourceType as RT

    if denoiser == Denoiser.REFERENCE:
        return {RT.IN_SIGNAL: fd.diff_noisy}
    base = {RT.IN_VIEWZ: fd.view_z, RT.IN_NORMAL_ROUGHNESS: gen.packed_normal_roughness(fd),
            RT.IN_MV: fd.mv}
    if denoiser == Denoiser.SIGMA_SHADOW:
        penumbra = fe.sigma_pack_penumbra_directional(torch.from_numpy(fd.dist_to_occluder),
                                                      gen.spec.light_tan_angular_radius)
        return {**base, RT.IN_PENUMBRA: penumbra.numpy()}
    if denoiser == Denoiser.REBLUR_DIFFUSE:
        view_z = torch.from_numpy(fd.view_z)
        nhd = fe.reblur_get_norm_hit_dist(torch.from_numpy(fd.diff_hit_dist), view_z,
                                          [3.0, 0.1, 20.0, -25.0], torch.ones_like(view_z))
        return {**base, RT.IN_DIFF_RADIANCE_HITDIST: fe.reblur_pack_radiance_hitdist(
            torch.from_numpy(fd.diff_noisy), nhd).numpy()}
    raise ValueError(f"no scene pool for {denoiser.name}")


def scene_frames(denoiser, size, frames: int, camera: str = "orbit", seed: int = 0):
    """(common settings, pool) of frames 0 .. frames - 1 of the orbit scene at size (w, h)."""
    from ..utils.scene import SceneGenerator, SceneSpec

    gen = SceneGenerator(SceneSpec(size=tuple(size), seed=seed), camera_mode=camera)
    for i in range(frames):
        fd = gen.frame(i)
        yield fd.common_settings, scene_pool(denoiser, gen, fd)


def save_frames(directory, frames) -> int:
    """Save (common settings, pool) frames for `run_engine(frame_dir=)`: each plane as an .npy
    file that a rank maps and reads its rows of. Returns the count."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    n = 0
    for i, (cs, pool) in enumerate(frames):
        for rt, plane in pool.items():
            np.save(directory / f"{i}_{rt.name}.npy", np.asarray(plane, np.float32))
        (directory / f"{i}_cs.pkl").write_bytes(pickle.dumps((cs, [rt.name for rt in pool])))
        n = i + 1
    return n


def saved_frames(directory, frames: int):
    """The frames of `save_frames`, each plane memory-mapped."""
    from ..settings import ResourceType

    directory = Path(directory)
    for i in range(frames):
        cs, names = pickle.loads((directory / f"{i}_cs.pkl").read_bytes())
        yield cs, {ResourceType[n]: np.load(directory / f"{i}_{n}.npy", mmap_mode="r")
                   for n in names}


def run_engine(mesh, denoiser, size, frames: int, device="cpu", camera="orbit", halos=None,
               frame_dir=None, frame_times=None):
    """The port's Engine (`Engine(mesh=mesh)`, or unsharded with mesh None) over `frames`
    frames at size (w, h): of the orbit scene, or the frames saved in `frame_dir`. halos: the
    instance's `halo_override` ({pass: rows}). frame_times: None keeps each frame's
    timeDeltaBetweenFrames (0 in the orbit scene: the Engine's own clock, rank 0's under a
    mesh), else the frame time (ms) of each frame, for example another run's `time_delta_ms`.
    Returns dict(outputs {name: (h, w, ...) float32 numpy} of the last frame, the whole frame on
    every rank; state_shapes {key: shape} of this rank's state; time_delta_ms [a frame], the
    frame time the frame's constants used; ms [a frame], this rank's wall time of each
    `denoise`, on the card between CUDA events; exchanged_bytes [a frame] this rank
    received)."""
    from ..engine import Engine
    from ..settings import Denoiser

    denoiser = Denoiser[denoiser] if isinstance(denoiser, str) else denoiser
    dev = mesh.device if mesh is not None else torch.device(device)
    eng = Engine({0: denoiser}, resource_size=tuple(size), mesh=mesh, device=dev)
    if halos is not None:
        eng._instances[0].halo_override = halos
    source = (saved_frames(frame_dir, frames) if frame_dir is not None
              else scene_frames(denoiser, size, frames, camera))
    ms, exchanged, time_delta = [], [], []
    outs = None
    for i, (cs, pool) in enumerate(source):
        if frame_times is not None:
            cs = dataclasses.replace(cs, timeDeltaBetweenFrames=float(frame_times[i]))
        eng.set_common_settings(cs)
        time_delta.append(cs.timeDeltaBetweenFrames if cs.timeDeltaBetweenFrames > 0
                          else eng._frame_math.update_timer(None))
        sharding.exchanged_bytes = 0
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs = eng.denoise([0], pool)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            outs = eng.denoise([0], pool)
            ms.append((time.perf_counter() - t0) * 1e3)
        exchanged.append(sharding.exchanged_bytes)
    state = eng.get_state(0)
    return dict(outputs={rt.name: sharding.gather_rows(t, mesh).float().cpu().numpy()
                         for rt, t in outs.items()},
                state_shapes={k: tuple(v.shape) for k, v in state.items()},
                time_delta_ms=time_delta, ms=ms, exchanged_bytes=exchanged)


def run_engine_ranks(mesh, cases):
    """`run_engine(mesh, **case)` of each case on every rank; rank 0's result is a list, a
    case, of run_engine's dict with `ms`, `exchanged_bytes`, `state_shapes` and `time_delta_ms`
    each a list a rank."""
    results = []
    for case in cases:
        r = run_engine(mesh, **case)
        for key in ("ms", "exchanged_bytes", "state_shapes", "time_delta_ms"):
            every = [None] * mesh.size
            dist.all_gather_object(every, r[key], group=mesh.group)
            r[key] = every
        results.append(r)
    return results
