"""The normal-roughness codec of the port (`nrdtpu_torch/frontend.py`) against the JAX package's
(`nrdtpu/frontend.py:34-97`) at all five normal encodings and the three roughness encodings,
quantized and not: `pack_normal_roughness`, `unpack_normal_roughness`, and the plane that the
kernels read, `decode_normal_plane` (at the RGBA formats the unpacked normal and the packed
roughness, at R10G10B10A2 the packed input itself), with its readers `unpack_normal_plane` and
`decode_roughness_plane`.

Inputs, made from a seed with numpy: the orbit scene's normals, roughness and materials at
64x48 (the sky's normal 0) and random normals of any length, zero vectors included.
Tolerance: packing equal to 1e-6 (the UNORM offset and the quantization round the same
float32 values; JAX's sqrt and PyTorch's differ in the last bit at SQRT_LINEAR), unpacking to
2 ulp of 1 (XLA's rsqrt against PyTorch's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu import frontend as jfe
from nrdtpu.settings import NormalEncoding as JNE, RoughnessEncoding as JRE
from nrdtpu.utils.scene import SceneGenerator, SceneSpec

from nrdtpu_torch import frontend as tfe
from nrdtpu_torch.settings import NormalEncoding as NE, RoughnessEncoding as RE

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

PACK_ATOL = 1e-6
UNPACK_ATOL = 2.4e-7
RGBA = (NE.RGBA8_UNORM, NE.RGBA8_SNORM, NE.RGBA16_UNORM, NE.RGBA16_SNORM)


@pytest.fixture(scope="module")
def inputs():
    """{name: (normal (h, w, 3), roughness, material)}: the scene's frame 0 and random
    vectors."""
    fd = SceneGenerator(SceneSpec(size=(64, 48), noise=0.4), camera_mode="orbit").frame(0)
    rng = np.random.default_rng(5)
    n = rng.normal(size=(48, 64, 3)).astype(np.float32) * rng.uniform(0.0, 3.0, (48, 64, 1))
    n[0, :8] = 0.0
    return {"scene": (fd.normal.astype(np.float32), fd.roughness.astype(np.float32),
                      fd.material_id.astype(np.float32)),
            "random": (n.astype(np.float32), rng.uniform(0.0, 1.0, (48, 64)).astype(np.float32),
                       rng.integers(0, 4, (48, 64)).astype(np.float32))}


def _packed(inputs, name, ne, re_, quantized):
    n, r, m = inputs[name]
    got = tfe.pack_normal_roughness(torch.from_numpy(n), torch.from_numpy(r),
                                    torch.from_numpy(m), ne, re_, quantized).numpy()
    want = np.asarray(jfe.pack_normal_roughness(jnp.asarray(n), jnp.asarray(r), jnp.asarray(m),
                                                JNE(int(ne)), JRE(int(re_)), quantized))
    return got, want


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("re_", list(RE), ids=[e.name for e in RE])
@pytest.mark.parametrize("ne", list(NE), ids=[e.name for e in NE])
@pytest.mark.parametrize("name", ["scene", "random"])
def test_pack_unpack_match_jax(inputs, name, ne, re_, quantized):
    got, want = _packed(inputs, name, ne, re_, quantized)
    assert got.shape == want.shape == inputs[name][0].shape[:2] + (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PACK_ATOL)
    p = torch.from_numpy(np.array(want))
    for g, w in zip(tfe.unpack_normal_roughness(p, ne, re_),
                    jfe.unpack_normal_roughness(jnp.asarray(want), JNE(int(ne)), JRE(int(re_)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=UNPACK_ATOL)


@pytest.mark.parametrize("ne", RGBA, ids=[e.name for e in RGBA])
@pytest.mark.parametrize("name", ["scene", "random"])
def test_decode_normal_plane(inputs, name, ne):
    """The decoded plane at every pixel: .xyz the JAX unpack's normal, .w the packed
    roughness; its readers give the unpack's normal, roughness and material (0) at every
    roughness encoding."""
    _, packed = _packed(inputs, name, ne, RE.LINEAR, True)
    p = torch.from_numpy(np.array(packed))
    plane = tfe.decode_normal_plane(p, ne)
    n_j = np.asarray(jfe.unpack_normal_roughness(jnp.asarray(packed), JNE(int(ne)))[0])
    np.testing.assert_allclose(plane[..., :3].numpy(), n_j, rtol=0, atol=UNPACK_ATOL)
    assert torch.equal(plane[..., 3], p[..., 3])
    assert tfe.decoded_normals(ne)
    for re_ in RE:
        want = tfe.unpack_normal_roughness(p, ne, re_)
        got = tfe.unpack_normal_plane(plane, True, re_)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), re_
        rp = tfe.decode_roughness_plane(plane, re_, decoded=True)
        assert torch.equal(rp[..., 3], want[1]) and torch.equal(rp[..., :3], plane[..., :3])


def test_r10_plane_is_the_input(inputs):
    """At R10G10B10A2 the kernels read the packed input: the plane is the input itself, and
    its readers unpack it."""
    _, packed = _packed(inputs, "scene", NE.R10_G10_B10_A2_UNORM, RE.SQ_LINEAR, True)
    p = torch.from_numpy(np.array(packed))
    assert tfe.decode_normal_plane(p, NE.R10_G10_B10_A2_UNORM) is p
    assert not tfe.decoded_normals(NE.R10_G10_B10_A2_UNORM)
    want = tfe.unpack_normal_roughness(p, roughness_encoding=RE.SQ_LINEAR)
    got = tfe.unpack_normal_plane(p, False, RE.SQ_LINEAR)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(tfe.decode_roughness_plane(p, RE.SQ_LINEAR)[..., 2], want[1])


def test_snorm_packs_the_sky_normal_exactly(inputs):
    """SNORM packs the sky's normal of 0 as 0, whose decoded normal is 0 (the reference's
    fault at RELAX_SPECULAR, `tests/test_torch_relax_enc_slice.py`); UNORM packs it as
    0.5 + rounding, a non-zero normal."""
    n, _, _ = inputs["scene"]
    sky = np.all(n == 0.0, -1)
    assert sky.any()
    for ne in RGBA:
        _, packed = _packed(inputs, "scene", ne, RE.LINEAR, True)
        plane = tfe.decode_normal_plane(torch.from_numpy(np.array(packed)), ne)
        dec = plane[..., :3].numpy()[sky]
        if ne in tfe.SNORM_ENCODINGS:
            assert not dec.any(), ne
        else:
            assert (np.abs(dec).sum(-1) > 0.5).all(), ne
