"""RELAX anti-firefly - kernel `csrc/relax_antifirefly.cu` (K21).

Replaces `nrdtpu/kernels/relax_pallas.py:537` (`relax_antifirefly_pallas`). Computes
`anti_firefly` (`nrdtpu/passes/relax/kernels.py:1279-1330`, the XLA branch `:1302-1326`) per
pixel for every signal given, in one launch: over the 8 neighbours of the clamp-to-edge 3x3
(row by row, centre excluded) whose material matches the centre's (max with the signal's
min material; the RGBA normal encodings carry no material and test none, `:1312`, the
kernel's kDec instance), the brightest and the darkest rgb by luminance (the
first one wins a tie); the centre's rgb becomes the brightest where it is brighter than all,
then the darkest where it is darker than all (RCRS). The signal's .w passes through.

Bound on the H100: bytes. Per pixel it reads the packed normal's material (every tap an L1
neighbour; the kDec instance reads none) and each signal once (16 B) and writes 16 B a
signal.
"""

from __future__ import annotations

import torch

from .. import frontend as fe
from .. import math as nm
from ..ops import stencil
from . import build

launches = 0
dec_launches = 0  # of the launches, those of the decoded-plane instance (kDec)
MAX_SIGNALS = 2


def relax_antifirefly_ref(normal_roughness, signals, *, min_materials, decoded=False):
    """Plain PyTorch version of the kernel (the XLA 3x3 loop), one output per signal."""
    material_id = fe.unpack_normal_plane(normal_roughness, decoded)[2]
    outs = []
    for signal, min_material in zip(signals, min_materials):
        luma = nm.luminance(signal[..., :3])
        best_max_l = torch.full_like(luma, -1.0)
        best_min_l = torch.full_like(luma, 1e6)
        best_max_rgb = signal[..., :3]
        best_min_rgb = signal[..., :3]
        mat_c = torch.clamp_min(material_id, min_material)
        for dy, dx in stencil.offsets_square(1, exclude_center=True):
            s = stencil.shifted(signal[..., :3], dy, dx)
            sl = nm.luminance(s)
            ok = torch.clamp_min(stencil.shifted(material_id, dy, dx), min_material) == mat_c
            gt = ok & (sl > best_max_l)
            best_max_l = torch.where(gt, sl, best_max_l)
            best_max_rgb = torch.where(gt[..., None], s, best_max_rgb)
            lt = ok & (sl < best_min_l)
            best_min_l = torch.where(lt, sl, best_min_l)
            best_min_rgb = torch.where(lt[..., None], s, best_min_rgb)
        rgb = signal[..., :3]
        rgb = torch.where((luma > best_max_l)[..., None], best_max_rgb, rgb)
        rgb = torch.where((luma < best_min_l)[..., None], best_min_rgb, rgb)
        outs.append(torch.cat([rgb, signal[..., 3:]], -1))
    return tuple(outs)


def relax_antifirefly(normal_roughness, signals, *, min_materials, decoded=False):
    """normal_roughness (h, w, 4) current (material in .w), or with `decoded` the RGBA
    formats' decoded plane (`frontend.decode_normal_plane`, no material); signals: the
    (h, w, 4) slow histories (1 or 2); min_materials: each signal's min material. Returns a
    tuple of (h, w, 4), one per signal."""
    global launches, dec_launches
    signals = tuple(signals)
    dev = build.kernel_device(normal_roughness)
    if dev is None:
        return relax_antifirefly_ref(normal_roughness, signals, min_materials=min_materials,
                                     decoded=decoded)
    h, w = normal_roughness.shape[:2]
    if not 1 <= len(signals) <= MAX_SIGNALS or len(min_materials) != len(signals):
        raise ValueError(f"signals: {len(signals)}, 1 to {MAX_SIGNALS} with a min material each")
    build.check("normal_roughness", normal_roughness, dev, torch.float32, (h, w, 4))
    for k, t in enumerate(signals):
        build.check(f"signals[{k}]", t, dev, torch.float32, (h, w, 4))
    out = torch.empty((len(signals), h, w, 4), dtype=torch.float32, device=dev)
    pad = [None] * (MAX_SIGNALS - len(signals))
    build.launch("nrd_relax_antifirefly", [normal_roughness, out, *signals, *pad],
                 [len(signals), *min_materials, *[0.0] * len(pad), decoded], w, h)
    launches += 1
    dec_launches += bool(decoded)
    return tuple(out)
