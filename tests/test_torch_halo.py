"""The halo-window launcher (K24): the port's `halo_call` (its plain version on the CPU) against
the JAX package's `halo_call` in Pallas interpret mode, with the same body written for each.

Images are made with numpy from a seed at an odd size (70x45), with 1 and 3 channels, halo 2
and 4, at a block that divides neither side of the image and at the TPU's default block; a
second body reads the scalars and writes the block's origin, which tells the blocks apart.
Tolerance: 1e-6 (the same float32 adds in the same order; XLA may fold the division).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nrdtpu.kernels.halo import halo_call as jax_halo_call

from nrdtpu_torch import kernels as KM
from nrdtpu_torch.kernels import halo

# the tensors here are small: one intra-op thread, so that test workers do not contend
torch.set_num_threads(1)

H, W = 45, 70
ATOL = 1e-6


def jax_box(scalar_ref, windows, outs, origin):
    """`halo.box` in the JAX body form."""
    for win, out in zip(windows, outs):
        bh, bw = out.shape[:2]
        n = win.shape[0] - bh + 1
        w = win[...]
        acc = jnp.zeros(out.shape, jnp.float32)
        for dy in range(n):
            for dx in range(n):
                acc = acc + w[dy:dy + bh, dx:dx + bw]
        out[...] = acc / float(n * n)


def jax_origin(scalar_ref, windows, outs, origin):
    """The centre pixel times scalars[0], plus y0 * scalars[1] + x0."""
    y0, x0 = origin
    win, out = windows[0], outs[0]
    bh, bw = out.shape[:2]
    hh = (win.shape[0] - bh) // 2
    centre = win[...][hh:hh + bh, hh:hh + bw]
    out[...] = (centre * scalar_ref[0] + y0.astype(jnp.float32) * scalar_ref[1]
                + x0.astype(jnp.float32))


def torch_origin(scalars, windows, outs, origin):
    y0, x0 = origin
    win, out = windows[0], outs[0]
    bh, bw = out.shape[1:3]
    hh = (win.shape[1] - bh) // 2
    centre = win[:, hh:hh + bh, hh:hh + bw]
    out[...] = (centre * scalars[0] + y0.to(torch.float32)[:, None, None] * scalars[1]
                + x0.to(torch.float32)[:, None, None])


def _image(channels, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 2.0, (H, W) + (() if channels == 1 else (channels,))).astype(
        np.float32)


@pytest.mark.parametrize("block", [(16, 32), (64, 256)], ids=["16x32", "64x256"])
@pytest.mark.parametrize("halo_px", [2, 4])
@pytest.mark.parametrize("channels", [1, 3])
def test_box_matches_jax(channels, halo_px, block):
    img = _image(channels)
    want = jax_halo_call(jax_box, [jnp.asarray(img)], [channels], halo_px, block=block,
                         interpret=True)
    KM.reset_launch_counts()
    got = halo.halo_call("box", [torch.from_numpy(img)], [channels], halo_px, block=block)
    assert KM.launch_counts()["halo_call"] == 0  # the CPU takes the plain version
    assert len(got) == len(want) == 1
    assert got[0].shape == tuple(want[0].shape)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)


def test_box_of_two_images():
    """One call, two images of different channel counts, one output each."""
    a, b = _image(1, 1), _image(3, 2)
    want = jax_halo_call(jax_box, [jnp.asarray(a), jnp.asarray(b)], [1, 3], 2, block=(16, 32),
                         interpret=True)
    got = halo.halo_call("box", [torch.from_numpy(a), torch.from_numpy(b)], [1, 3], 2,
                         block=(16, 32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("block", [(16, 32), (8, 24)], ids=["16x32", "8x24"])
def test_origin_and_scalars_match_jax(block):
    """A body that writes the block's origin and reads the scalars: each block is placed where
    the JAX launcher places it."""
    img = _image(1, 3)
    scalars = np.array([0.5, 1000.0], np.float32)
    want = jax_halo_call(jax_origin, [jnp.asarray(img)], [1], 3, block=block,
                         scalars=jnp.asarray(scalars), interpret=True)[0]
    got = halo.halo_call_ref(torch_origin, [torch.from_numpy(img)], [1], 3, block=block,
                             scalars=torch.from_numpy(scalars))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    ys, xs = np.meshgrid(np.arange(H) // block[0] * block[0], np.arange(W) // block[1] * block[1],
                         indexing="ij")
    np.testing.assert_allclose(got.numpy() - 0.5 * img, ys * 1000.0 + xs, atol=1e-3)


def test_calls_that_no_kernel_runs_raise():
    img = torch.from_numpy(_image(3))
    with pytest.raises(ValueError, match="no halo body"):
        halo.halo_call("sharpen", [img], [3], 2)
    with pytest.raises(ValueError, match="channel count"):
        halo.halo_call("box", [img], [1], 2)
    with pytest.raises(ValueError, match="images"):
        halo.halo_call("box", [img] * 5, [3] * 5, 2)
