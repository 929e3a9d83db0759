"""The PyTorch port's building blocks against the JAX package: settings, per-frame host math,
the scene generator and packed normals, and the resampling / stencil ops that every kernel's
plain version is made of. Inputs are made with numpy from a seed and go to both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import camera as jcam
from nrdtpu import frontend as jfe
from nrdtpu import settings as js
from nrdtpu.ops import resample as jrs
from nrdtpu.ops import stencil as jst
from nrdtpu.utils.scene import SceneGenerator as JScene, SceneSpec as JSpec

from nrdtpu_torch import camera as tcam
from nrdtpu_torch import frontend as tfe
from nrdtpu_torch import settings as ts
from nrdtpu_torch.ops import resample as trs
from nrdtpu_torch.ops import stencil as tst
from nrdtpu_torch.utils.scene import SceneGenerator as TScene, SceneSpec as TSpec

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

RNG_SEED = 7
# resampling ops: the same float32 op order on both sides, so only the last bit of a
# product or quotient may differ (XLA may contract a*b+c)
ATOL = 1e-6


def test_settings_round_trip():
    """Every enum member and every settings default matches the JAX package."""
    for name in ("Denoiser", "ResourceType", "NormalEncoding", "RoughnessEncoding",
                 "CheckerboardMode", "AccumulationMode", "HitDistanceReconstructionMode"):
        assert ({m.name: int(m) for m in getattr(ts, name)}
                == {m.name: int(m) for m in getattr(js, name)}), name
    for d in js.Denoiser:
        a = dataclasses.asdict(ts.default_settings(ts.Denoiser(int(d))))
        b = dataclasses.asdict(js.default_settings(d))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    r = ts.replace(ts.ReblurSettings(), maxAccumulatedFrameNum=12)
    assert r.maxAccumulatedFrameNum == 12 and r.historyFixFrameNum == 3


@pytest.mark.parametrize("mode", ["static", "orbit", "zoom"])
def test_frame_math_matches(mode):
    """FrameMath constants over 4 frames of each scene camera, timer included.
    Tolerance: the rotators go through float32 cos/sin, numpy's against XLA's (1 ulp)."""
    jg = JScene(JSpec(size=(64, 48)), camera_mode=mode)
    jf, tf = jcam.FrameMath(), tcam.FrameMath()
    for i in range(4):
        cs = jg.frame(i).common_settings
        if i == 2:
            cs.timeDeltaBetweenFrames = 16.66
        a = jf.set_common_settings(cs, 20.0 + i)
        b = tf.set_common_settings(cs, 20.0 + i)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(np.asarray(b[k], np.float64), np.asarray(a[k], np.float64),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{mode} frame {i}: {k}")


@pytest.mark.parametrize("mode", ["static", "orbit"])
def test_scene_generator_and_packing_match_exactly(mode):
    jg = JScene(JSpec(size=(64, 48), seed=3), camera_mode=mode)
    tg = TScene(TSpec(size=(64, 48), seed=3), camera_mode=mode)
    for i in (0, 2):
        a, b = jg.frame(i), tg.frame(i)
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(vb, va, err_msg=f.name)
        np.testing.assert_array_equal(tg.packed_normal_roughness(b), jg.packed_normal_roughness(a))


def test_pack_normal_roughness_exact_on_random_normals():
    rng = np.random.default_rng(RNG_SEED)
    n = rng.normal(size=(32, 32, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    r = rng.uniform(size=(32, 32)).astype(np.float32)
    m = rng.integers(0, 4, size=(32, 32)).astype(np.float32)
    want = np.asarray(jfe.pack_normal_roughness(jnp.asarray(n), jnp.asarray(r), jnp.asarray(m),
                                                quantized=True))
    got = tfe.pack_normal_roughness(torch.from_numpy(n), torch.from_numpy(r),
                                    torch.from_numpy(m), quantized=True).numpy()
    np.testing.assert_array_equal(got, want)
    # unpack: safe-normalized decode, roughness, material
    jn, jr, jm = jfe.unpack_normal_roughness(jnp.asarray(want))
    tn, tr, tm = tfe.unpack_normal_roughness(torch.from_numpy(np.array(want)))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=ATOL)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(RNG_SEED)
    img = rng.uniform(-1.0, 2.0, size=(24, 40, 4)).astype(np.float32)
    # sample positions spread past every edge, fractional
    pos = np.stack([rng.uniform(-3.0, 43.0, size=(16, 16)),
                    rng.uniform(-3.0, 27.0, size=(16, 16))], -1).astype(np.float32)
    occ = (rng.uniform(size=(16, 16, 4)) > 0.3).astype(np.float32)
    wts = rng.uniform(size=(16, 16, 4)).astype(np.float32) * occ
    use = rng.uniform(size=(16, 16)) > 0.4
    return img, pos, wts, use


@pytest.mark.parametrize("channels", [1, 4])
def test_sample_catrom(images, channels):
    img, pos, wts, use = images
    img = img[..., 0] if channels == 1 else img
    want = jrs.sample_catrom(jnp.asarray(img), jnp.asarray(pos), jnp.asarray(use),
                             jnp.asarray(wts))
    got = trs.sample_catrom(torch.from_numpy(img), torch.from_numpy(pos),
                            torch.from_numpy(use), torch.from_numpy(wts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bilinear_custom_and_texel_fetch(images):
    img, pos, wts, _ = images
    origin = np.floor(pos - 0.5)
    want = jrs.bilinear_custom(jnp.asarray(img), jnp.asarray(origin), jnp.asarray(wts))
    got = trs.bilinear_custom(torch.from_numpy(img), torch.from_numpy(origin),
                              torch.from_numpy(wts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    x, y = origin[..., 0].astype(np.int32), origin[..., 1].astype(np.int32)
    np.testing.assert_array_equal(
        trs.texel_fetch(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jrs.texel_fetch(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))))
    uv = pos / np.array([40.0, 24.0], np.float32)
    np.testing.assert_array_equal(
        trs.sample_nearest(torch.from_numpy(img), torch.from_numpy(uv)).numpy(),
        np.asarray(jrs.sample_nearest(jnp.asarray(img), jnp.asarray(uv))))
    np.testing.assert_array_equal(
        trs.is_in_screen_nearest(torch.from_numpy(uv)).numpy(),
        np.asarray(jrs.is_in_screen_nearest(jnp.asarray(uv))))
    np.testing.assert_array_equal(
        trs.is_in_screen_bilinear(torch.from_numpy(origin), (40.0, 24.0)).numpy(),
        np.asarray(jrs.is_in_screen_bilinear(jnp.asarray(origin), jnp.asarray([40.0, 24.0]))))
    np.testing.assert_array_equal(trs.pixel_uv_grid(24, 40).numpy(),
                                  np.asarray(jrs.pixel_uv_grid(24, 40)))


@pytest.mark.parametrize("dy,dx", [(-2, 1), (0, -3), (1, 1), (3, 0)])
def test_stencil_shifted(images, dy, dx):
    img = images[0]
    np.testing.assert_array_equal(tst.shifted(torch.from_numpy(img), dy, dx).numpy(),
                                  np.asarray(jst.shifted(jnp.asarray(img), dy, dx)))
    assert tst.offsets_square(2) == jst.offsets_square(2)


@pytest.mark.parametrize("frame_index", [0, 7, 123457, 2**31 + 12345, 2**32 - 1])
def test_hash_is_bit_exact(frame_index):
    """The PCG stream (int64 emulation of uint32) equals nrdtpu.math's, draw for draw, over a
    64x48 grid; it drives the stochastic nearest fetches and the PrePass hitDist minimum."""
    from nrdtpu import math as jm
    from nrdtpu_torch import math as tm

    xs, ys = np.meshgrid(np.arange(64, dtype=np.int32), np.arange(48, dtype=np.int32))
    js = jm.hash_init((jnp.asarray(xs), jnp.asarray(ys)), frame_index)
    ts = tm.hash_init(torch.from_numpy(xs), torch.from_numpy(ys), frame_index)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for _ in range(3):
        js, ja = jm.hash_float(js)
        ts, ta = tm.hash_float(ts)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        js, jb = jm.hash_float2(js)
        ts, tb = tm.hash_float2(ts)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
