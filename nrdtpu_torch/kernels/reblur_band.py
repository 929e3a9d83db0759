"""REBLUR HistoryFix + Blur + PostBlur of both signals in one launch - kernel
`csrc/reblur_band.cu` (K23).

Replaces `nrdtpu/kernels/reblur_band.py:496` (`reblur_spatial_band`, whose `pl.pallas_call` is
at :614), which REBLUR_DIFFUSE_SPECULAR runs once a frame under NRDTPU_REBLUR_BAND=1 in place
of the three-launch chain (`nrdtpu/passes/reblur/denoiser.py:403-428`). It computes what the
port's chain computes for both radiance signals (`passes/reblur/kernels.py:spatial_chain`):

  A. the history fix: N5's body (`history_fix_fused`: the 20 stride taps, the 3x3
     fast-history moments, the anti-firefly ring where a signal's flag is set, then the clamp
     `passes/reblur/params.py:history_fix_clamp`); it writes sig2 and fast2;
  B. Blur: the BLUR planes of each signal (`params.diff_spatial_params` /
     `spec_spatial_params`: the rotator, the diffuse screen-space skew, the radius, the
     normal, hit-distance and roughness weights) from sig2's hit distance and the
     accumulation speed, then N4's tap loop (`spatial_filter_fused`); it writes sig3;
  C. PostBlur: the same with the POST_BLUR constants on sig3; it writes sig4.

One thread per (pixel, signal) in 16x16 tiles. Each phase reads the previous one's output at
its taps, so the entry makes ordinary launches on the caller's stream, one per phase after a
prologue that unpacks each pixel's tap geometry (normal, scaled viewZ) once, and stream order
separates them; each phase has its own register budget. sig2, sig3 and the geometry live in
float32 scratch that the wrapper allocates. The wrapper counts one launch per call (one call of
the entry); a launch error raises, as every launch error does.

The plain version `reblur_band_ref` is that chain on torch tensors: N5's plain version (the
clamp included), the parameters and N4's plain version twice, so on the CPU the band and the
chain give identical results.

Not carried over from the TPU kernel: the bf16 band windows and buffers
(`reblur_band.py:537-553`, `:595-597`), the zeroed stride and radius of sky pixels (`:128`,
`:182`), the 40-row bands, 8-row chunks and column splits (`:48-56`, `:520-528`), the two-band
delay of fast2 (`:491-493`), the performance-mode ring radius of 3 (`:517`), and the
directional mode, which the port does not run yet.

With the occlusion variants (the TPU kernel's `occlusion`, `reblur_band.py:497`) both signals are
(h, w, 1) hit distances: N5's one-channel body, then the Blur and PostBlur parameters with the
min hit-distance weight without its sqrt(nlas) (`_blur_params`, `:192`), one float a pixel a
signal in sig2, sig3 and the output.

With the SH variants (`sh`, both signals' SH1 after TA; TPU `reblur_band.py:512`, `:546`,
`:631-634`) each phase carries each signal's SH as N5's and N4's SH modes do: the history fix's
taps and luma scale, then the Blur and PostBlur taps; sh2 and sh3 take two more (2, h, w, 4)
float32 scratch planes.

Bound on the H100: per pixel at 2560x1440 it reads the two TA signals (32 B), their
accumulation speeds and fast histories (16 B), viewZ and the packed normal (20 B), 14 shared
planes (56 B) and 5 + 9 history-fix planes (56 B), and writes both PostBlur signals and fast
histories (40 B): 220 B/px of compulsory traffic. The scratch round trips of sig2 and sig3
add 128 B/px. The taps (20 + 8 + 8 a signal) hit L1/L2.
"""

from __future__ import annotations

import torch

from .. import vec3 as v3
from ..passes.reblur import common as C
from ..passes.reblur import params as P
from . import build
from . import history_fix as hf
from . import history_fix_fused as hff
from . import spatial_filter as sf
from . import spatial_filter_fused as sff

launches = 0
dec_launches = 0  # of them, the instances on the decoded plane of the RGBA formats (kDec)

# the per-pixel planes of the frame's geometry, in order: the history fix's shared planes,
# then what the Blur and PostBlur parameters read
PLANES = hf.SHARED + ("nov", "roughness", "smc", "hd_scale_diff", "hd_scale_spec")
STAGES = (P.BLUR, P.POST_BLUR)


def _geometry(planes, view_z_in, view_z_scale, enc_err):
    """The `make_filter_geometry` entries that the Blur and PostBlur parameters read."""
    p = dict(zip(PLANES, planes))
    return dict(view_z=torch.abs(view_z_in) * view_z_scale, frustum_size=p["frustum_size"],
                nov=p["nov"], roughness=p["roughness"], smc=p["smc"],
                hd_scale_diff=p["hd_scale_diff"], hd_scale_spec=p["hd_scale_spec"],
                nv3=v3.V3(p["nvx"], p["nvy"], p["nvz"]), enc_err=enc_err)


def reblur_band_ref(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1, diff_fast,
                    spec_fast, planes, diff_params, spec_params, *, frustum, rect_size,
                    rect_size_inv, view_z_scale, ortho_mode, diff_min_material,
                    spec_min_material, rotator, rotator_post, enc_err, dc, perf_mode,
                    anti_firefly=(False, False), sh=None, decoded=False):
    """Plain version: N5's plain version (the history fix and its clamp), and for Blur and
    PostBlur the parameters and N4's plain version."""
    p = dict(zip(PLANES, planes))
    res = hff.history_fix_fused_ref(
        diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1, diff_fast, spec_fast,
        planes[:len(hf.SHARED)], diff_params, spec_params, p["smc"], frustum=frustum,
        rect_size_inv=rect_size_inv, view_z_scale=view_z_scale, ortho_mode=ortho_mode,
        diff_min_material=diff_min_material, spec_min_material=spec_min_material, dc=dc,
        anti_firefly=anti_firefly, sh=sh, decoded=decoded)
    geom = _geometry(planes, view_z_in, view_z_scale, enc_err)
    sig = dict(diff=res["diff"], spec=res["spec"])
    if sh is not None:
        sig.update(diff_sh=res["diff_sh"], spec_sh=res["spec_sh"])
    out = dict(diff_fast=res["diff_fast"], spec_fast=res["spec_fast"])
    sc = dict(rect_size_inv=rect_size_inv, rotator=rotator, rotator_post=rotator_post)
    shared = torch.stack([p[k] for k in sf.SHARED])
    occ = diff.shape[-1] == 1
    for mode in STAGES:
        sig = sff.spatial_filter_fused_ref(
            sig["diff"], sig["spec"], view_z_in, normal_roughness, shared,
            P.diff_spatial_params(sc, dc, mode, geom, sig["diff"], diff_data1, occlusion=occ),
            P.spec_spatial_params(sc, dc, mode, geom, sig["spec"], spec_data1, occlusion=occ),
            frustum=frustum, rect_size=rect_size, view_z_scale=view_z_scale,
            ortho_mode=ortho_mode, diff_min_material=diff_min_material,
            spec_min_material=spec_min_material, perf_mode=perf_mode,
            sh=None if sh is None else (sig["diff_sh"], sig["spec_sh"]), decoded=decoded)
    out.update(sig)
    return out


def band_consts(dc, *, rotator, rotator_post, enc_err):
    """The host constants of the clamp and of the Blur / PostBlur parameters, each the float32
    value that the plain version's torch ops see."""
    fade_a, fade_ba = C.fade_bounds(dc)
    laf = float(dc["lobe_angle_fraction"])
    consts = [P.history_fix_frame_div(dc), P.fast_history_enabled(dc), fade_a, fade_ba,
              float(dc["max_blur_radius"]), float(dc["min_blur_radius"]), laf, 1.0 - laf,
              enc_err, *P._v(rotator), *P._v(rotator_post)]
    for mode in STAGES:
        fraction_scale, radius_scale = P.STAGE_SCALES[mode]
        consts += [fraction_scale, radius_scale, P.min_hit_dist_weight_scale(dc, fraction_scale),
                   P.roughness_fraction_scaled(dc, fraction_scale)]
    return consts


def reblur_band(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1, diff_fast,
                spec_fast, planes, diff_params, spec_params, *, frustum, rect_size,
                rect_size_inv, view_z_scale, ortho_mode, diff_min_material, spec_min_material,
                rotator, rotator_post, enc_err, dc, perf_mode, anti_firefly=(False, False),
                sh=None, decoded=False):
    """diff, spec (h, w, 4), or (h, w, 1) each with the occlusion variants (no SH): the TA
    outputs; *_data1, *_fast (h, w); planes (14, h, w) named by
    PLANES; diff_params (5, h, w) named by history_fix.PARAMS, spec_params (9, h, w) by PARAMS
    + SPEC_PARAMS; rotator, rotator_post: the Blur and PostBlur rotators; dc: the REBLUR frame
    constants; anti_firefly: (diffuse, specular) ring flags; sh: with the SH variants the
    (diffuse, specular) SH1 after TA, (h, w, 4) each; decoded: normal_roughness is the RGBA
    formats' decoded plane (`frontend.decode_normal_plane`, its roughness decoded; the kernel's
    kDec instances), else packed R10G10B10A2. Returns dict(diff, spec, diff_fast, spec_fast[,
    diff_sh, spec_sh]): the PostBlur signals, the history fix's fast histories and the PostBlur
    SH."""
    global launches, dec_launches
    sh = None if sh is None else tuple(sh)
    kw = dict(frustum=frustum, rect_size=rect_size, rect_size_inv=rect_size_inv,
              view_z_scale=view_z_scale, ortho_mode=ortho_mode,
              diff_min_material=diff_min_material, spec_min_material=spec_min_material,
              rotator=rotator, rotator_post=rotator_post, enc_err=enc_err, dc=dc,
              perf_mode=perf_mode, anti_firefly=tuple(anti_firefly), sh=sh, decoded=decoded)
    if sh is not None and (len(sh) != 2 or any(t is None for t in sh)):
        raise ValueError("sh: the SH1 of both signals")
    if planes.shape[0] != len(PLANES):
        raise ValueError(f"planes: {planes.shape[0]} planes, expected {len(PLANES)}")
    if (diff_params.shape[0] != len(hf.PARAMS)
            or spec_params.shape[0] != len(hf.PARAMS + hf.SPEC_PARAMS)):
        raise ValueError("diff_params takes the diffuse planes, spec_params the specular ones")
    c = build.channels("diff", diff, sh)
    dev = build.kernel_device(diff)
    if dev is None:
        return reblur_band_ref(diff, spec, view_z_in, normal_roughness, diff_data1, spec_data1,
                               diff_fast, spec_fast, planes, diff_params, spec_params, **kw)
    h, w = view_z_in.shape
    f32 = torch.float32
    ins = [("diff", diff, (h, w, c)), ("spec", spec, (h, w, c)), ("diff_data1", diff_data1, (h, w)),
           ("spec_data1", spec_data1, (h, w)), ("diff_fast", diff_fast, (h, w)),
           ("spec_fast", spec_fast, (h, w)),
           ("diff_params", diff_params, (diff_params.shape[0], h, w)),
           ("spec_params", spec_params, (spec_params.shape[0], h, w)),
           ("view_z_in", view_z_in, (h, w)), ("normal_roughness", normal_roughness, (h, w, 4)),
           ("planes", planes, (len(PLANES), h, w))]
    if sh is not None:
        ins += [("diff_sh", sh[0], (h, w, 4)), ("spec_sh", sh[1], (h, w, 4))]
    for name, t, shape in ins:
        build.check(name, t, dev, f32, shape)
    out = torch.empty((2, h, w, c), dtype=f32, device=dev)
    fast = torch.empty((2, h, w), dtype=f32, device=dev)
    # sig2 and sig3 ((2, h, w, c) each: c planes of (h, w, 4)), the tap geometry, and with SH
    # sh2, sh3
    scratch = torch.empty((c + 1 + (0 if sh is None else 4), h, w, 4), dtype=f32, device=dev)
    out_sh = None if sh is None else torch.empty((2, h, w, 4), dtype=f32, device=dev)
    consts = [*frustum, rect_size[0], rect_size[1], rect_size_inv[0], rect_size_inv[1],
              view_z_scale, ortho_mode, diff_min_material, spec_min_material,
              *map(bool, anti_firefly), sf.ntaps(perf_mode),
              *band_consts(dc, rotator=rotator, rotator_post=rotator_post, enc_err=enc_err),
              sh is not None, c == 1, decoded]
    build.launch("nrd_reblur_band", [t for _, t, _ in ins[:11]] + [scratch, fast, out]
                 + list(sh or (None, None)) + [out_sh], consts, w, h)
    launches += 1
    dec_launches += bool(decoded)
    res = dict(diff=out[0], spec=out[1], diff_fast=fast[0], spec_fast=fast[1])
    if sh is not None:
        res.update(diff_sh=out_sh[0], spec_sh=out_sh[1])
    return res
