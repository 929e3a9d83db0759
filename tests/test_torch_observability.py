"""The debug and host surface of the port on the CPU against the JAX package: the OUT_VALIDATION
overlay as a function (`passes/validation.py:render_validation`), the memory query for all 19
variants, and SIGMA_SHADOW's printfAt probe and SHOW capture through the Engine (the JAX Engine
run op by op, `jax.disable_jit()`). RELAX's overlay and probe are in
`tests/test_torch_observability_relax.py`, REBLUR's overlay, probe and SHOW in
`_observability_reblur.py` and `_observability_modes.py`; they share this file's helpers. Each
file holds one denoiser family: op by op, JAX compiles every primitive of a family once a
process (~20-30 s).

Tolerances:
- the overlay function: rtol 1e-5, atol 1e-6 on every channel; the world-units layer of
  viewport 4 by the wrap-aware distance min(|d|, 1 - |d|) (it is mod(x_world + 0.001 viewZ, 1):
  a sum an ulp from an integer lands at ~0 on one side and ~1 on the other), the jitter and
  rotator trails exactly. With the orbit camera the view rotation makes x_world a three-term
  product, which XLA's matrix product on the CPU rounds in no fixed order (neither its jitted
  nor its eager form matches any one order of the three terms), so x_world may differ by an
  ulp: there the world-units layer is held within 2 ulp of the scene's world coordinates
  (|x| < 32, `UNITS_ALLOWANCE`) and viewport 3, the MV difference, which subtracts two
  reprojections of x_world and scales them by the rect, within what 4 ulp of a uv near 1 move
  at that rect (`MV_ALLOWANCE`); with an axis-aligned camera x_world is exact in any order and
  both are held like the rest;
- through the Engine: frame 0 all zeros on both sides (a history reset clears the overlay),
  frames 1-2 >= 60 dB; the probe's values at rtol 1e-4, atol 1e-5, on frame 0 and on frame 1
  run from JAX's state after frame 0 carried across with `interop`;
- memory: `persistent_mb` exactly the JAX Engine's.

Run alone: python -m pytest tests/test_torch_observability.py -q
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrdtpu import camera as jcamera
from nrdtpu.engine import DenoiserConfig as JConfig, Engine as JEngine
from nrdtpu.passes import validation as jvalidation
from nrdtpu.settings import Denoiser as JDenoiser, ResourceType as JRT
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import camera as tcamera
from nrdtpu_torch import interop
from nrdtpu_torch.engine import DenoiserConfig as TConfig, Engine as TEngine
from nrdtpu_torch.passes import validation as tvalidation
from nrdtpu_torch.settings import Denoiser, ResourceType as RT
from nrdtpu_torch.utils.scene import SceneGenerator as TSceneGenerator

from test_torch_rect_slice import rect_pool
from test_torch_relax_slice import psnr

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

SIZE = (64, 48)
PROBE_AT = (40, 30)  # a geometry pixel of the orbit scene's frames 0-2 at SIZE
PSNR_BAR_DB = 60.0
PROBE_RTOL, PROBE_ATOL = 1e-4, 1e-5
FUNC_SIZE = (62, 45)  # not a multiple of 4: the last viewport row and column are cropped
MV_ALLOWANCE = FUNC_SIZE[0] * 2.0 ** -21
UNITS_ALLOWANCE = 2.0 ** -18


@functools.lru_cache(maxsize=None)
def scene(size=SIZE):
    return SceneGenerator(SceneSpec(size=size, noise=0.4), camera_mode="orbit")


# ---------------------------------------------------------------------------------------------
# the Engine against the JAX Engine (helpers shared by the REBLUR files)
# ---------------------------------------------------------------------------------------------

def run_pair(variant, n, debug, show=None, pool_of=rect_pool):
    """`n` frames of the orbit scene through the JAX Engine (op by op) and two port Engines on
    the CPU, with `debug(i, cs)` setting frame i's debug fields and `show` the SHOW tag: "own"
    runs its own chain, "carried" each frame i >= 1 from JAX's state after frame i - 1
    (`interop.state_from_numpy`). Returns a dict a frame: the common settings, JAX's outputs,
    probe, SHOW plane and state (numpy), and each port engine's outputs and memory figures."""
    je = JEngine({0: JDenoiser[variant]}, resource_size=SIZE)
    ports = {k: TEngine({0: Denoiser[variant]}, resource_size=SIZE, device="cpu")
             for k in ("own", "carried")}
    if show is not None:
        je.set_debug_show(show)
        for eng in ports.values():
            eng.set_debug_show(show)
    frames = []
    for i in range(n):
        fd = scene().frame(i)
        cs = fd.common_settings
        cs.timeDeltaBetweenFrames = 16.66  # no wall-clock frame rate
        debug(i, cs)
        pool = pool_of(variant, fd, i)
        je.set_common_settings(cs)
        with jax.disable_jit():
            jo = je.denoise([0], {JRT(int(k)): v for k, v in pool.items()})
        frame = dict(cs=cs, jax={k: np.asarray(v) for k, v in jo.items()
                                 if isinstance(k, JRT)},
                     jprobe=({k: np.asarray(v) for k, v in jo[JEngine.PROBE_KEY].items()}
                             if JEngine.PROBE_KEY in jo else None),
                     jshow=(None if jo.get(JEngine.SHOW_KEY) is None
                            else np.asarray(jo[JEngine.SHOW_KEY])),
                     has_show=JEngine.SHOW_KEY in jo,
                     jstate={k: np.asarray(v) for k, v in je.get_state(0).items()})
        for name, eng in ports.items():
            if name == "carried" and i > 0:
                eng._states[0] = interop.state_from_numpy(frames[-1]["jstate"])
            eng.set_common_settings(cs)
            frame[name] = eng.denoise([0], pool)
            frame[name + "_memory"] = eng.get_memory_usage(0)
        frames.append(frame)
    return frames


def jax_persistent_mb(jstate):
    """The JAX Engine's `persistent_mb` of a state (`nrdtpu/engine.py:229-230`); read off the
    state, since its `get_memory_usage` compiles the whole frame for its temporaries."""
    return sum(v.nbytes for v in jstate.values()) / (1024 * 1024)


def check_overlay_frames(frames):
    """OUT_VALIDATION of both port engines: all zeros on frame 0 as on JAX's, >= 60 dB against
    JAX's on the later frames; the persistent memory is JAX's state's, overlay included."""
    for i, f in enumerate(frames):
        want = f["jax"][JRT.OUT_VALIDATION]
        for name in ("own", "carried"):
            got = f[name][RT.OUT_VALIDATION].numpy()
            assert got.shape == (SIZE[1], SIZE[0], 4) and np.isfinite(got).all()
            if i == 0:
                assert not want.any() and not got.any(), name
            else:
                assert want[..., 3].max() == 1.0  # the overlay renders
                p = psnr(got, want)
                assert p >= PSNR_BAR_DB, f"frame {i} {name}: {p:.2f} dB"
            mem = f[name + "_memory"]
            assert mem["persistent_mb"] == jax_persistent_mb(f["jstate"]), (i, name)
            assert mem["aliasable_mb"] == 0.0 and mem["total_mb"] == mem["persistent_mb"]


def check_probe(frames, frame_index, engine):
    """The port's probe dict of one frame: JAX's keys, each value at rtol 1e-4, atol 1e-5."""
    f = frames[frame_index]
    want, got = f["jprobe"], f[engine][TEngine.PROBE_KEY]
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), v.astype(np.float32),
                                   rtol=PROBE_RTOL, atol=PROBE_ATOL, err_msg=k)


def check_show(frames, frame_index, engine):
    f = frames[frame_index]
    got = f[engine].get(TEngine.SHOW_KEY)
    assert f["has_show"] and TEngine.SHOW_KEY in f[engine]
    if f["jshow"] is None:
        assert got is None
        return
    assert tuple(got.shape) == f["jshow"].shape == (SIZE[1], SIZE[0])
    np.testing.assert_allclose(got.float().numpy(), f["jshow"].astype(np.float32),
                               rtol=PROBE_RTOL, atol=PROBE_ATOL)


# ---------------------------------------------------------------------------------------------
# the overlay as a function
# ---------------------------------------------------------------------------------------------

def _mv_mask(h, w):
    """Viewport 3, the MV difference, of an (h, w) overlay."""
    h4, w4 = -(-h // 4), -(-w // 4)
    mv = np.zeros((4 * h4, 4 * w4), bool)
    mv[:h4, 3 * w4:4 * w4] = True
    return mv[:h, :w]


def _function_inputs(rng, fd, w, h):
    view_z = fd.view_z.copy()
    view_z[rng.uniform(size=view_z.shape) < 0.1] *= -1.0  # negative viewZ: blue
    mv = (fd.mv + rng.normal(0.0, 1e-3, fd.mv.shape)).astype(np.float32)
    accum = rng.uniform(0.0, 70.0, (2, h, w)).astype(np.float32)
    accum[rng.uniform(size=accum.shape) < 0.2] = 0.0  # reset histories: the checker
    hit = rng.uniform(-0.2, 1.2, (2, h, w)).astype(np.float32)  # outside [0, 1]: magenta
    hit[rng.uniform(size=hit.shape) < 0.2] = 0.0  # red
    vha = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    return view_z, TSceneGenerator.packed_normal_roughness(fd), mv, accum, hit, vha


@pytest.mark.parametrize("camera", ["axis_aligned", "orbit"])
def test_overlay_function_matches_jax(camera):
    """Three chained frames (the previous overlay carried) of `render_validation` on seeded
    inputs and the frames' constants: frame 0 a history reset (all zeros), frame 1 at a frame
    index that is a multiple of 256 (the rotator trail cleared), frame 2 with the jitter moved
    off the pixel (the red jitter mark)."""
    w, h = FUNC_SIZE
    gen = scene(FUNC_SIZE)
    rng = np.random.default_rng(25)
    jfm, tfm = jcamera.FrameMath(), tcamera.FrameMath()
    jcfg = JConfig(JDenoiser.REBLUR_DIFFUSE_SPECULAR, FUNC_SIZE, FUNC_SIZE)
    tcfg = TConfig(Denoiser.REBLUR_DIFFUSE_SPECULAR, FUNC_SIZE, FUNC_SIZE)
    squares, units = tvalidation.viewport4_masks(h, w)
    mv_cell = _mv_mask(h, w)
    jprev = tprev = None
    for i in range(3):
        fd = gen.frame(i)
        cs = fd.common_settings
        cs.frameIndex = 255 + i
        cs.cameraJitter = tuple(float(v) for v in rng.uniform(-0.5, 0.5, 2))
        if camera == "axis_aligned":  # translation only: x_world exact in any order
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = (-0.3 * i, 0.1 * i, 0.2)
            cs.worldToViewMatrix = m.reshape(-1, order="F").tolist()
        jsc = jfm.set_common_settings(cs, 16.66)
        tsc = interop.consts_from_numpy(tfm.set_common_settings(cs, 16.66))
        if i == 2:
            jsc = dict(jsc, jitter=np.array([0.6, -0.2], np.float32))
            tsc = dict(tsc, jitter=np.array([0.6, -0.2], np.float32))
        view_z, nr, mv, accum, hit, vha = _function_inputs(rng, fd, w, h)
        want = np.asarray(jvalidation.render_validation(
            jsc, jnp.asarray(view_z), jnp.asarray(nr), jnp.asarray(mv), jcfg,
            jnp.asarray(accum[0]), jnp.asarray(accum[1]), jnp.asarray(vha), 63.0,
            jnp.asarray(hit[0]), jnp.asarray(hit[1]), jprev))
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (view_z, nr, mv, vha)]
        got = tvalidation.render_validation(
            tsc, t[0], t[1], t[2], tcfg, torch.from_numpy(accum[0]),
            torch.from_numpy(accum[1]), t[3], 63.0, torch.from_numpy(hit[0]),
            torch.from_numpy(hit[1]), tprev)
        jprev, tprev = jnp.asarray(want), got
        got = got.numpy()
        assert got.shape == want.shape == (h, w, 4)
        if i == 0:
            assert not want.any() and not got.any()
            continue
        assert want[..., 3].max() == 1.0
        d = np.abs(got - want)
        wrap = np.minimum(d, 1.0 - d)
        np.testing.assert_array_equal(got[squares], want[squares])  # the trails, exactly
        units_atol = UNITS_ALLOWANCE if camera == "orbit" else 1e-6
        assert (wrap[units][:, :3] <= units_atol + 1e-5 * np.abs(want[units][:, :3])).all()
        rest = ~(squares | units)
        if camera == "orbit":
            np.testing.assert_allclose(got[mv_cell], want[mv_cell], rtol=0, atol=MV_ALLOWANCE)
            rest &= ~mv_cell
        np.testing.assert_allclose(got[rest], want[rest], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[units][:, 3], want[units][:, 3])
    assert got[squares].any()  # the trails show


# ---------------------------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [d.name for d in Denoiser])
def test_persistent_memory_matches_jax(variant):
    """After a frame at 32x24, `persistent_mb` is the JAX Engine's for its state (the state
    `denoise` makes on the first frame, `init_state`, which its frames keep); `aliasable_mb` is
    0.0 on the CPU and `total_mb` the sum."""
    size = (32, 24)
    je = JEngine({0: JDenoiser[variant]}, resource_size=size)
    je._states[0] = je._instances[0].init_state()
    want = je.get_memory_usage(0)
    eng = TEngine({0: Denoiser[variant]}, resource_size=size, device="cpu")
    assert eng.get_memory_usage(0)["persistent_mb"] == 0.0  # no state before the first frame
    fd = scene(size).frame(0)
    eng.set_common_settings(fd.common_settings)
    eng.denoise([0], rect_pool(variant, fd, 0))
    got = eng.get_memory_usage(0)
    assert got["persistent_mb"] == want["persistent_mb"] > 0.0
    assert got["aliasable_mb"] == 0.0 and got["total_mb"] == got["persistent_mb"]


# ---------------------------------------------------------------------------------------------
# SIGMA through the Engine
# ---------------------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sigma_frames():
    """SIGMA_SHADOW: printfAt on frames 0 and 1, SHOW of one of its tags on frames 1 and 2, and
    frame 2 without printfAt (SIGMA emits only under printfAt)."""
    def debug(i, cs):
        cs.printfAt = PROBE_AT if i < 2 else (9999, 9999)
    return run_pair("SIGMA_SHADOW", 3, debug, show="sigma/blur/penumbra1")


@pytest.mark.parametrize("frame,engine", [(0, "own"), (1, "carried")])
def test_sigma_probe_matches_jax(frame, engine):
    """SIGMA's tags at the probe pixel with JAX's values (tiles_smoothed is probed at the
    pixel's index into the tile grid, as the reference probes it, and so only where it has
    one)."""
    frames = sigma_frames()
    check_probe(frames, frame, engine)
    # the 16x16-pixel tile grid (4x3 at SIZE) has no texel at the probe pixel's index
    assert set(frames[frame]["jprobe"]) == {"sigma/blur/penumbra1", "sigma/postblur/penumbra2",
                                            "sigma/history_len"}


def test_sigma_show_is_none_without_printf():
    """SIGMA emits its tags under printfAt only (`nrdtpu/passes/sigma/denoiser.py:110-115`):
    with printfAt its SHOW tag is captured, without it the SHOW plane is None on both sides; the
    outputs and state match JAX's all the while."""
    frames = sigma_frames()
    check_show(frames, 1, "carried")
    assert frames[1]["jshow"] is not None
    assert frames[2]["jshow"] is None and frames[2]["carried"][TEngine.SHOW_KEY] is None
    for f in frames[1:]:
        got = f["carried"][RT.OUT_SHADOW_TRANSLUCENCY].numpy()
        assert psnr(got, f["jax"][JRT.OUT_SHADOW_TRANSLUCENCY]) >= PSNR_BAR_DB
