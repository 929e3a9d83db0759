"""Halo-window stencil launcher - kernel template `csrc/halo.cuh`, bodies in `csrc/halo.cu`
(K24).

Replaces `nrdtpu/kernels/halo.py:30` (`halo_call`, whose `pl.pallas_call` is at :130) with its
signature and semantics: the image is cut into blocks of `block` = (bh, bw) pixels; a body
sees, for each input image, the block's window of (bh + 2 halo, bw + 2 halo) pixels, clamped to
the image's edge, writes one value per pixel (and channel) of each output block, and knows the
block's origin (y0, x0). Outputs are float32 (H, W) or (H, W, C), cropped to the image.

A body is named. On the card the name selects a device functor compiled into `halo.cu`; each
CTA stages its block's edge-clamped windows in dynamic shared memory (indices clamped on load,
no pre-padded copy), waits at a barrier, and calls the functor once per output pixel. A window
taller than one CTA's shared memory (227 KB on the H100) is staged in strips of whole output
rows, each with its halo rows; the block and its origin stay as asked. A call whose windows do
not fit even one output row at a time raises. On the CPU the name selects the body's torch
form in BODIES; `halo_call_ref` also takes any torch body.

A torch body is `body(scalars, windows, outs, origin)`, called once with every block stacked
along a leading axis: windows[k] is (nblocks, bh + 2 halo, bw + 2 halo[, C]), outs[k] is
(nblocks, bh, bw[, C]) and is written in place, origin is (y0, x0), two (nblocks,) int64
tensors. The JAX form's refs are the same arrays without the leading axis.

The JAX package has no caller of `halo_call`; the one body here, `box`, exists to hold the
launcher against its plain version: the mean of each channel over the (2 halo + 1)^2 window.

Bound on the H100: `box` reads each input once and writes each output once (8 B per pixel and
channel); its (2 halo + 1)^2 adds a channel come from shared memory.
"""

from __future__ import annotations

import torch

from . import build

launches = 0

MAX_IMAGES = 4  # inputs and outputs of one call (csrc/halo.cuh:kHaloMaxImages)


def box(scalars, windows, outs, origin):
    """The mean of each channel over the (2 halo + 1)^2 window, output k from image k."""
    for win, out in zip(windows, outs):
        bh, bw = out.shape[1:3]
        n = win.shape[1] - bh + 1
        acc = torch.zeros_like(out)
        for dy in range(n):
            for dx in range(n):
                acc = acc + win[:, dy:dy + bh, dx:dx + bw]
        out[...] = acc / float(n * n)


BODIES = {"box": box}
BODY_IDS = {"box": 0}  # the functor's index in csrc/halo.cu


def _blocks(h, w, block):
    bh, bw = block
    return -(-h // bh), -(-w // bw)


def halo_call_ref(body, images, out_channels, halo, block=(64, 256), scalars=None):
    """Plain version: every block's window gathered from the image padded with
    mode="replicate", the torch body applied to all blocks at once, the blocks put back in
    place and cropped to the image."""
    fn = BODIES[body] if isinstance(body, str) else body
    h, w = images[0].shape[:2]
    bh, bw = block
    gh, gw = _blocks(h, w, block)
    dev = images[0].device
    y0 = (torch.arange(gh, device=dev) * bh).repeat_interleave(gw)
    x0 = (torch.arange(gw, device=dev) * bw).repeat(gh)
    rows = y0[:, None] + torch.arange(bh + 2 * halo, device=dev)[None, :]
    cols = x0[:, None] + torch.arange(bw + 2 * halo, device=dev)[None, :]
    windows = []
    for img in images:
        chw = img[None, None] if img.ndim == 2 else img.permute(2, 0, 1)[None]
        pad = (halo, halo + gw * bw - w, halo, halo + gh * bh - h)
        padded = torch.nn.functional.pad(chw, pad, mode="replicate")[0].permute(1, 2, 0)
        win = padded[rows[:, :, None], cols[:, None, :]]
        windows.append(win[..., 0] if img.ndim == 2 else win)
    outs = [torch.zeros((gh * gw, bh, bw) + (() if c == 1 else (c,)), dtype=torch.float32,
                        device=dev) for c in out_channels]
    fn(scalars, windows, outs, (y0, x0))
    res = []
    for o in outs:
        o = o.reshape((gh, gw) + o.shape[1:]).transpose(1, 2)
        res.append(o.reshape((gh * bh, gw * bw) + o.shape[4:])[:h, :w].contiguous())
    return tuple(res)


def halo_call(body, images, out_channels, halo, block=(64, 256), scalars=None):
    """body: a name in BODIES; images: up to 4 float32 (H, W) or (H, W, C) tensors of one
    size; out_channels: the channel count of each output (1: an (H, W) output); halo: the
    window's margin in pixels; block: (bh, bw); scalars: an optional (N,) float32 tensor the
    body reads. Returns the outputs, a tuple."""
    global launches
    if body not in BODIES:
        raise ValueError(f"no halo body {body!r}: the bodies are {sorted(BODIES)}")
    if not 1 <= len(images) <= MAX_IMAGES or not 1 <= len(out_channels) <= MAX_IMAGES:
        raise ValueError(f"1 to {MAX_IMAGES} images and outputs")
    if body == "box" and list(out_channels) != [1 if i.ndim == 2 else i.shape[2] for i in images]:
        raise ValueError("box writes one output of each image's channel count")
    kw = dict(block=block, scalars=scalars)
    dev = build.kernel_device(images[0])
    if dev is None:
        return halo_call_ref(body, images, out_channels, halo, **kw)
    h, w = images[0].shape[:2]
    channels = []
    for k, img in enumerate(images):
        if img.ndim not in (2, 3):
            raise ValueError(f"images[{k}]: (H, W) or (H, W, C), got {tuple(img.shape)}")
        build.check(f"images[{k}]", img, dev, torch.float32, (h, w) + tuple(img.shape[2:]))
        channels.append(1 if img.ndim == 2 else img.shape[2])
    if scalars is not None:
        build.check("scalars", scalars, dev, torch.float32, (scalars.shape[0],))
    outs = [torch.empty((h, w) + (() if c == 1 else (c,)), dtype=torch.float32, device=dev)
            for c in out_channels]
    pad = [None] * MAX_IMAGES
    ptrs = (list(images) + pad)[:MAX_IMAGES] + (outs + pad)[:MAX_IMAGES] + [scalars]
    consts = [BODY_IDS[body], halo, block[0], block[1], len(images), len(outs),
              *(channels + [0] * MAX_IMAGES)[:MAX_IMAGES],
              0 if scalars is None else scalars.shape[0]]
    build.launch("nrd_halo_call", ptrs, consts, w, h)
    launches += 1
    return tuple(outs)
