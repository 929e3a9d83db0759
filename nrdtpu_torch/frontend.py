"""Application-facing pack/unpack contract (`NRD.hlsli`) - the part the ported slices need,
counterpart of `nrdtpu/frontend.py`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as nm
from .settings import NormalEncoding, RoughnessEncoding

NRD_FP16_MAX = 65504.0
NRD_EPS = 1e-6
NRD_INF = 1e6
NRD_ROUGHNESS_EPS = float(torch.sqrt(torch.sqrt(torch.tensor(NRD_EPS, dtype=torch.float32))))
NRD_MATERIAL_FACTOR_MIN_SCALE = 0.02
NRD_ROUGHNESS_FACTOR_MIN_SCALE = 0.1
NRD_REJITTER_VIEWZ_THRESHOLD = 0.01


def pack_normal_roughness(n, roughness, material_id=0.0,
                          normal_encoding=NormalEncoding.R10_G10_B10_A2_UNORM,
                          roughness_encoding=RoughnessEncoding.LINEAR,
                          quantized=False):
    """NRD_FrontEnd_PackNormalAndRoughness (NRD.hlsli:640-667). Returns (..., 4): R10G10B10A2
    the octahedral normal, roughness and material / 3; the RGBA formats the best-fit scaled
    normal (0.5 n + 0.5 for UNORM) and roughness, no material. `quantized` rounds to the
    format's bits."""
    if roughness_encoding == RoughnessEncoding.SQRT_LINEAR:
        roughness = torch.sqrt(nm.saturate(roughness))
    elif roughness_encoding == RoughnessEncoding.SQ_LINEAR:
        roughness = roughness * roughness
    if normal_encoding != NormalEncoding.R10_G10_B10_A2_UNORM:
        # best-fit scaling (NRD.hlsli:656); NaN-safe for garbage (sky) inputs
        n = n / torch.clamp_min(torch.amax(torch.abs(n), -1, keepdim=True), 1e-15)
        signed = normal_encoding in SNORM_ENCODINGS
        if not signed:
            n = n * 0.5 + 0.5
        p = torch.cat([n, roughness[..., None]], -1)
        if quantized:
            bits = 8 if normal_encoding in RGBA8_ENCODINGS else 16
            p = nm.quantize_snorm(p, bits) if signed else nm.quantize_unorm(p, bits)
        return p
    material_id = torch.broadcast_to(torch.as_tensor(material_id, dtype=torch.float32,
                                                     device=roughness.device),
                                     roughness.shape)
    xy = nm.encode_unit_vector(n, signed=False)
    p = torch.stack([xy[..., 0], xy[..., 1], roughness, nm.saturate(material_id / 3.0)], -1)
    if quantized:
        p = torch.cat([nm.quantize_unorm(p[..., :3], 10), nm.quantize_unorm(p[..., 3:], 2)],
                      -1)
    return p


SNORM_ENCODINGS = (NormalEncoding.RGBA8_SNORM, NormalEncoding.RGBA16_SNORM)
RGBA8_ENCODINGS = (NormalEncoding.RGBA8_UNORM, NormalEncoding.RGBA8_SNORM)


def _decode_roughness(r, roughness_encoding):
    if roughness_encoding == RoughnessEncoding.SQRT_LINEAR:
        return r * r
    if roughness_encoding == RoughnessEncoding.SQ_LINEAR:
        return torch.sqrt(nm.saturate(r))
    return r


def unpack_normal_roughness(p, normal_encoding=NormalEncoding.R10_G10_B10_A2_UNORM,
                            roughness_encoding=RoughnessEncoding.LINEAR):
    """NRD_FrontEnd_UnpackNormalAndRoughness (NRD.hlsli:600-628).
    Returns (normal (..., 3), roughness (...,), material_id (...,)); the RGBA formats carry no
    material (0)."""
    if normal_encoding == NormalEncoding.R10_G10_B10_A2_UNORM:
        n = nm.decode_unit_vector(p[..., :2], signed=False, do_normalize=False)
        roughness, material_id = p[..., 2], p[..., 3] * 3.0
    else:
        n = p[..., :3]
        if normal_encoding not in SNORM_ENCODINGS:
            n = n * 2.0 - 1.0
        roughness, material_id = p[..., 3], torch.zeros_like(p[..., 3])
    return (nm.safe_normalize(n), _decode_roughness(roughness, roughness_encoding),
            material_id)


def decoded_normals(normal_encoding) -> bool:
    """Whether the kernels and the pass glue read IN_NORMAL_ROUGHNESS through
    `decode_normal_plane` (the four RGBA formats) or as packed (R10G10B10A2)."""
    return normal_encoding != NormalEncoding.R10_G10_B10_A2_UNORM


def decode_normal_plane(p, normal_encoding):
    """The normal-roughness plane (..., 4) that the kernels and the glue read: at R10G10B10A2
    the packed input itself; at the RGBA formats (.xyz the unpacked normal, .w the roughness
    as packed), the normal of `unpack_normal_roughness` decoded once a frame, the same values
    that unpacking at every read gives. The kernels' decoded mode (`kDec`) reads it, the
    roughness decoded by the roughness encoding as before and the material 0."""
    if not decoded_normals(normal_encoding):
        return p
    return torch.cat([unpack_normal_roughness(p, normal_encoding)[0], p[..., 3:4]], -1)


def unpack_normal_plane(p, decoded=False, roughness_encoding=RoughnessEncoding.LINEAR):
    """(normal, roughness, material id) of a plane of `decode_normal_plane`: packed
    R10G10B10A2 (`decoded` False), or decoded, its material 0."""
    if not decoded:
        return unpack_normal_roughness(p, roughness_encoding=roughness_encoding)
    return p[..., :3], _decode_roughness(p[..., 3], roughness_encoding), torch.zeros_like(
        p[..., 3])


def decode_roughness_plane(p, roughness_encoding, decoded=False):
    """A copy of the normal-roughness plane (..., 4) with its roughness lane (.z packed, .w
    decoded, `decode_normal_plane`) decoded as unpack_normal_roughness decodes it (SQRT_LINEAR
    r * r, SQ_LINEAR sqrt(saturate(r))), so that a reader at LINEAR sees the same values; at
    LINEAR the plane itself."""
    if roughness_encoding == RoughnessEncoding.LINEAR:
        return p
    lane = 3 if decoded else 2
    r = _decode_roughness(p[..., lane:lane + 1], roughness_encoding)
    return torch.cat([p[..., :lane], r, p[..., lane + 1:]], -1)


def get_hit_distance_normalization(view_z, hit_dist_params, roughness):
    """_REBLUR_GetHitDistanceNormalization (NRD.hlsli:520-523); params are host (A, B, C, D)."""
    a, b, c, d = (float(v) for v in hit_dist_params)
    return (a + torch.abs(view_z) * b) * nm.lerp(
        1.0, c, nm.saturate(torch.exp2(d * roughness * roughness)))


def reblur_get_norm_hit_dist(hit_dist, view_z, hit_dist_params, roughness):
    """REBLUR_FrontEnd_GetNormHitDist (NRD.hlsli:722-727)."""
    return nm.saturate(hit_dist / get_hit_distance_normalization(view_z, hit_dist_params,
                                                                 roughness))


def reblur_get_hit_dist(norm_hit_dist, view_z, hit_dist_params, roughness=1.0):
    """REBLUR_GetHitDist (NRD.hlsli:1146-1151): the hit distance of a normalized one."""
    return norm_hit_dist * get_hit_distance_normalization(view_z, hit_dist_params, roughness)


def _sanitize(x, lo, hi):
    return torch.where(torch.isfinite(x), torch.clamp(x, lo, hi), 0.0)


def reblur_pack_radiance_hitdist(radiance, norm_hit_dist, sanitize=True):
    """REBLUR_FrontEnd_PackRadianceAndNormHitDist (NRD.hlsli:732-743)."""
    if sanitize:
        radiance = _sanitize(radiance, 0.0, NRD_FP16_MAX)
        norm_hit_dist = _sanitize(norm_hit_dist, 0.0, 1.0)
    return torch.cat([nm.linear_to_ycocg(radiance), norm_hit_dist[..., None]], -1)


def reblur_unpack_radiance_hitdist(data):
    """REBLUR_BackEnd_UnpackRadianceAndNormHitDist (NRD.hlsli:863-868)."""
    return torch.cat([nm.ycocg_to_linear(data[..., :3]), data[..., 3:4]], -1)


def reblur_pack_sh(radiance, norm_hit_dist, direction, sanitize=True):
    """REBLUR_FrontEnd_PackSh (NRD.hlsli:748-766): sh0 = (YCoCg, normHitDist), sh1 =
    (direction x the luma Y, 0). Returns (sh0, sh1), (..., 4) each."""
    if sanitize:
        radiance = _sanitize(radiance, 0.0, NRD_FP16_MAX)
        norm_hit_dist = _sanitize(norm_hit_dist, 0.0, 1.0)
        direction = _sanitize(direction, -1.0, 1.0)
    ycocg = nm.linear_to_ycocg(radiance)
    c1 = direction * ycocg[..., 0:1]
    return (torch.cat([ycocg, norm_hit_dist[..., None]], -1),
            torch.cat([c1, torch.zeros_like(c1[..., :1])], -1))


def reblur_pack_directional_occlusion(direction, norm_hit_dist, sanitize=True):
    """REBLUR_FrontEnd_PackDirectionalOcclusion (NRD.hlsli:770-781): (direction x the
    normalized hit distance, the normalized hit distance), (..., 4)."""
    if sanitize:
        direction = _sanitize(direction, -1.0, 1.0)
        norm_hit_dist = _sanitize(norm_hit_dist, 0.0, 1.0)
    return torch.cat([direction * norm_hit_dist[..., None], norm_hit_dist[..., None]], -1)


def relax_pack_radiance_hitdist(radiance, hit_dist, sanitize=True):
    """RELAX_FrontEnd_PackRadianceAndHitDist (NRD.hlsli:789-798): raw radiance and raw hitT
    (not REBLUR's normalized hit distance)."""
    if sanitize:
        radiance = _sanitize(radiance, 0.0, NRD_FP16_MAX)
        hit_dist = _sanitize(hit_dist, 0.0, NRD_FP16_MAX)
    return torch.cat([radiance, hit_dist[..., None]], -1)


def relax_pack_sh(radiance, hit_dist, direction, sanitize=True):
    """RELAX_FrontEnd_PackSh (NRD.hlsli:802-818): sh0 = (radiance, raw hitT), sh1 = (direction x
    the radiance's luminance, 0). Returns (sh0, sh1), (..., 4) each."""
    if sanitize:
        radiance = _sanitize(radiance, 0.0, NRD_FP16_MAX)
        hit_dist = _sanitize(hit_dist, 0.0, NRD_FP16_MAX)
        direction = _sanitize(direction, -1.0, 1.0)
    sh0 = torch.cat([radiance, hit_dist[..., None]], -1)
    c1 = direction * nm.luminance(radiance)[..., None]
    return sh0, torch.cat([c1, torch.zeros_like(c1[..., :1])], -1)


def relax_unpack_radiance(color):
    """RELAX_BackEnd_UnpackRadiance (NRD.hlsli:903-906): the identity."""
    return color


def sigma_pack_penumbra_directional(distance_to_occluder, tan_of_light_angular_radius):
    """SIGMA_FrontEnd_PackPenumbra, directional light (NRD.hlsli:828-834)."""
    penumbra_radius = distance_to_occluder * tan_of_light_angular_radius * 0.5
    return torch.where(distance_to_occluder >= NRD_FP16_MAX, NRD_FP16_MAX,
                       torch.clamp_max(penumbra_radius, 32768.0))


def sigma_pack_penumbra_local(distance_to_occluder, distance_to_light, light_size):
    """SIGMA_FrontEnd_PackPenumbra, local light (NRD.hlsli:837-845)."""
    penumbra_size = light_size * distance_to_occluder / torch.clamp_min(
        distance_to_light - distance_to_occluder, NRD_EPS)
    return torch.where(distance_to_occluder >= NRD_FP16_MAX, NRD_FP16_MAX,
                       torch.clamp_max(penumbra_size * 0.5, 32768.0))


def sigma_pack_translucency(distance_to_occluder, translucency):
    """SIGMA_FrontEnd_PackTranslucency (NRD.hlsli:848-855)."""
    x = (distance_to_occluder >= NRD_FP16_MAX).to(torch.float32)
    return torch.cat([x[..., None], nm.saturate(translucency)], -1)


def sigma_unpack_shadow(shadow):
    """SIGMA_BackEnd_UnpackShadow (NRD.hlsli:931): the shadow is stored as its square root."""
    return shadow * shadow


def environment_term_rtg(rf0, nov, roughness):
    """_NRD_EnvironmentTerm_Rtg (NRD.hlsli:490-517) - preintegrated GGX environment BRDF."""
    m = nm.saturate(roughness * roughness)
    x1, xn, xz, xw = 1.0, nov, nov * nov, nov * nov * nov
    y1, ym, yz, yw = 1.0, m, m * m, m * m * m

    def dot2(mat, a, b):
        return mat[0][0] * a[0] * b[0] + mat[0][1] * a[0] * b[1] + \
            mat[1][0] * a[1] * b[0] + mat[1][1] * a[1] * b[1]

    def dot3(mat, a, b):
        s = 0.0
        for i in range(3):
            for j in range(3):
                s = s + mat[i][j] * a[i] * b[j]
        return s

    m1 = ((0.99044, -1.28514), (1.29678, -0.755907))
    m2 = ((1.0, 2.92338, 59.4188), (20.3225, -27.0302, 222.592), (121.563, 626.13, 316.627))
    m3 = ((0.0365463, 3.32707), (9.0632, -9.04756))
    m4 = ((1.0, 3.59685, -1.36772), (9.04401, -16.3174, 9.22949), (5.56589, 19.7886, -20.2123))

    bias = dot2(m1, (x1, xn), (y1, ym)) / torch.clamp_min(
        dot3(m2, (x1, xn, xw), (y1, ym, yw)), NRD_EPS)
    scale = dot2(m3, (x1, xn), (y1, ym)) / torch.clamp_min(
        dot3(m4, (x1, xz, xw), (y1, ym, yw)), NRD_EPS)
    return nm.saturate(rf0 * scale[..., None] + bias[..., None])


def material_factors(n, v, albedo, rf0, roughness):
    """NRD_MaterialFactors (NRD.hlsli:676-687): (diffFactor, specFactor)."""
    nov = torch.abs(nm.dot(n, v))
    fenv = environment_term_rtg(rf0, nov, roughness)
    diff = nm.lerp(NRD_MATERIAL_FACTOR_MIN_SCALE, 1.0, (1.0 - fenv) * albedo)
    spec = fenv * nm.lerp(NRD_ROUGHNESS_FACTOR_MIN_SCALE, 1.0, roughness[..., None])
    return diff, nm.lerp(NRD_MATERIAL_FACTOR_MIN_SCALE, 1.0, spec)


def get_normalized_strand_thickness(strand_thickness, pixel_size):
    """NRD_GetNormalizedStrandThickness (NRD.hlsli:1158-1161)."""
    return pixel_size / (pixel_size + strand_thickness)


# ---------------------------------------------------------------------------
# SG / SH resolve suite (NRD.hlsli:536-592, 933-1133): what a renderer reads REBLUR's SH
# outputs with
# ---------------------------------------------------------------------------


class SG(NamedTuple):
    """NRD_SG (NRD.hlsli:541-549)."""

    c0: torch.Tensor         # (...,)
    chroma: torch.Tensor     # (..., 2)
    norm_hit_dist: torch.Tensor
    c1: torch.Tensor         # (..., 3)
    sharpness: torch.Tensor


def sg_create(radiance, direction, norm_hit_dist) -> SG:
    """_NRD_SG_Create (NRD.hlsli:551-563)."""
    ycocg = nm.linear_to_ycocg(radiance)
    c0 = ycocg[..., 0]
    return SG(c0=c0, chroma=ycocg[..., 1:3], norm_hit_dist=norm_hit_dist,
              c1=direction * c0[..., None], sharpness=torch.zeros_like(c0))


def reblur_unpack_sh(sh0, sh1) -> SG:
    """REBLUR_BackEnd_UnpackSh (NRD.hlsli:872-882)."""
    return SG(c0=sh0[..., 0], chroma=sh0[..., 1:3], norm_hit_dist=sh0[..., 3],
              c1=sh1[..., :3], sharpness=sh1[..., 3])


def reblur_unpack_directional_occlusion(data) -> SG:
    """REBLUR_BackEnd_UnpackDirectionalOcclusion (NRD.hlsli:885-895): c0 and the normalized
    hit distance are .w, c1 is .xyz, no chroma and no sharpness."""
    c0 = data[..., 3]
    return SG(c0=c0, chroma=torch.zeros(data.shape[:-1] + (2,), dtype=data.dtype,
                                        device=data.device),
              norm_hit_dist=c0, c1=data[..., :3], sharpness=torch.zeros_like(c0))


def _sg_extract_direction(sg: SG):
    return sg.c1 / torch.clamp_min(nm.length(sg.c1)[..., None], NRD_EPS)


def _sg_integral_approx(c0, sharpness):
    return 2.0 * nm.PI * (c0 / sharpness)


def _sg_inner_product(a_c0, a_dir, a_sharp, b_c0, b_dir, b_sharp):
    """_NRD_SG_InnerProduct (NRD.hlsli:582-592)."""
    d = nm.length(a_sharp[..., None] * a_dir + b_sharp[..., None] * b_dir)
    c = torch.exp(d - a_sharp - b_sharp)
    c = c * (1.0 - torch.exp(-2.0 * d))
    c = c / torch.clamp_min(d, NRD_EPS)
    return nm.PI * nm.saturate(2.0 * c * a_c0) * b_c0


def _geometry_term(roughness, nol, nov):
    m = roughness * roughness
    m2 = m * m
    a = nol + torch.sqrt(nm.saturate((nol - m2 * nol) * nol + m2))
    b = nov + torch.sqrt(nm.saturate((nov - m2 * nov) * nov + m2))
    return 1.0 / torch.clamp_min(a * b, NRD_EPS)


# BRDF terms of NRD_SG_ReJitter (NRD.hlsli:407-488)
def _pow5(x):
    return torch.pow(nm.saturate(1.0 - x), 5.0)


def _fresnel_term(rf0, vonh):
    return rf0 + (1.0 - rf0) * _pow5(vonh)


def _distribution_term(roughness, noh):
    m = roughness * roughness
    m2 = m * m
    a = m / ((noh * m2 - noh) * noh + 1.0)
    return a * a / nm.PI


def _diffuse_term(roughness, nol, nov, voh):
    f = 2.0 * voh * voh * (roughness * roughness) - 0.5
    return (f * _pow5(nov) + 1.0) * (f * _pow5(nol) + 1.0) / nm.PI


def compute_brdfs(ld, ls, n, v, rf0, roughness):
    """_NRD_ComputeBrdfs (NRD.hlsli:453-488): (diff, spec) for the diffuse and specular
    light directions."""
    nov = torch.abs(nm.dot(n, v))
    h = nm.normalize(ld + v)
    nol = nm.saturate(nm.dot(n, ld))
    voh = nm.saturate(nm.dot(v, h))
    diff = (1.0 - _fresnel_term(rf0, voh)) * _diffuse_term(roughness, nol, nov, voh) * nol

    h = nm.normalize(nm.lerp(n, nm.normalize(ls + v), roughness[..., None]))
    nol = nm.saturate(nm.dot(n, ls))
    noh = nm.saturate(nm.dot(n, h))
    voh = nm.saturate(nm.dot(v, h))
    spec = (_fresnel_term(rf0, voh) * _distribution_term(roughness, noh)
            * _geometry_term(roughness, nol, nov) * nol)
    return diff, spec


def sg_rejitter(diff_sg: SG, spec_sg: SG, rf0, v, roughness,
                z, ze, zw, zn, zs, n, ne, nw, nn, ns):
    """NRD_SG_ReJitter (NRD.hlsli:1064-1111): the (..., 2) jacobian (diffuse, specular) that
    moves the resolved SG to the jittered pixel's BRDF, 1 unless the four neighbours (east,
    west, north, south: view z and normal) all lie on the centre's surface."""
    roughness = torch.clamp_min(roughness, NRD_ROUGHNESS_EPS)
    rf0l = nm.luminance(rf0)
    ld = _sg_extract_direction(diff_sg)
    smc = 1.0 - torch.exp2(-30.0 * roughness * roughness)  # _NRD_GetSpecMagicCurve
    ls = nm.normalize(nm.lerp(v, _sg_extract_direction(spec_sg), smc[..., None]))

    cd, cs_ = compute_brdfs(ld, ls, n, v, rf0l, roughness)
    ad, as_ = compute_brdfs(ld, ls, ne, v, rf0l, roughness)
    for nb in (nn, nw, ns):
        d2, s2 = compute_brdfs(ld, ls, nb, v, rf0l, roughness)
        ad, as_ = ad + d2, as_ + s2

    nov = torch.abs(nm.dot(n, v))
    z_threshold = NRD_REJITTER_VIEWZ_THRESHOLD * torch.abs(z) / (nov * 0.95 + 0.05)
    total = sum(((torch.abs(zx - z) < z_threshold) & (nm.dot(nx, n) > 0.0)).to(torch.int32)
                for zx, nx in ((ze, ne), (zn, nn), (zw, nw), (zs, ns)))
    fd = (cd * 4.0 + NRD_EPS) / (ad + NRD_EPS)
    fs = (cs_ * 4.0 + NRD_EPS) / (as_ + NRD_EPS)
    f = torch.clamp(torch.stack(torch.broadcast_tensors(fd, fs), -1), 1.0 / nm.PI, nm.PI)
    return torch.where((total != 4)[..., None], torch.ones_like(f), f)


def is_valid_radiance(radiance):
    """NRD_IsValidRadiance (NRD.hlsli:1140-1144): every channel finite."""
    return torch.all(torch.isfinite(radiance), dim=-1)


def _ycocg_to_linear_corrected(y, y0, cocg):
    """_NRD_YCoCgToLinear_Corrected (NRD.hlsli:377-383)."""
    y = torch.clamp_min(y, 0.0)
    cocg = cocg * ((y + nm.EPS) / (y0 + nm.EPS))[..., None]
    return nm.ycocg_to_linear(torch.cat([y[..., None], cocg], -1))


def sg_extract_color(sg: SG):
    """NRD_SG_ExtractColor (NRD.hlsli:937-940): the linear colour of SH0."""
    return nm.ycocg_to_linear(torch.cat([sg.c0[..., None], sg.chroma], -1))


def sg_resolve_diffuse(sg: SG, n):
    """NRD_SG_ResolveDiffuse (NRD.hlsli:957-1007), the numeric-integration fit."""
    sharpness = 4.0
    c0k = 0.36
    c1k = 1.0 / (4.0 * c0k)
    e = float(torch.exp(torch.tensor(-sharpness, dtype=torch.float32)))
    e2 = e * e
    r = 1.0 / sharpness
    scale = 1.0 + 2.0 * e2 - r
    bias = (e - e2) * r - e2
    nol = nm.dot(n, _sg_extract_direction(sg))
    x = float(torch.sqrt(torch.clamp(torch.tensor(1.0 - scale, dtype=torch.float32), 0.0, 1.0)))
    x0 = c0k * nol
    x1 = c1k * x
    nn = x0 + x1
    y = torch.where(torch.abs(x0) <= x1, nn * nn / max(x, NRD_EPS), nm.saturate(nol))
    yy = scale * y + bias
    yy = yy * _sg_integral_approx(sg.c0, torch.full_like(sg.c0, sharpness))
    return _ycocg_to_linear_corrected(yy, sg.c0, sg.chroma)


def sg_resolve_specular(sg: SG, n, v, roughness):
    """NRD_SG_ResolveSpecular (NRD.hlsli:1009-1055)."""
    roughness = torch.clamp_min(roughness, NRD_ROUGHNESS_EPS)
    sg_sharp = torch.full_like(sg.c0, 2.0)
    h = nm.normalize(_sg_extract_direction(sg) + v)
    h = nm.normalize(nm.lerp(n, h, roughness[..., None]))
    m = roughness * roughness
    m2 = m * m
    ndf_c0 = 1.0 / (nm.PI * m2) * nm.lerp(1.0, 0.75 * 2.0 * nm.PI, m2)
    ndf_sharp = 2.0 / torch.clamp_min(m2, NRD_EPS)
    warped_dir = nm.reflect(-v, h)
    warped_sharp = ndf_sharp / torch.clamp_min(4.0 * torch.abs(nm.dot(h, v)), NRD_EPS)
    nov = torch.abs(nm.dot(n, v))
    nol = nm.saturate(nm.dot(n, warped_dir))
    warped_c0 = ndf_c0 * nol * _geometry_term(roughness, nol, nov)
    y = _sg_inner_product(warped_c0, warped_dir, warped_sharp, sg.c0, _sg_extract_direction(sg),
                          sg_sharp)
    return _ycocg_to_linear_corrected(y, sg.c0, sg.chroma)


def sh_resolve_diffuse(sh: SG, n):
    """NRD_SH_ResolveDiffuse (NRD.hlsli:1117-1122)."""
    y = nm.dot(n, sh.c1) + 0.5 * sh.c0
    return _ycocg_to_linear_corrected(y, sh.c0, sh.chroma)


def sh_resolve_specular(sh: SG, n, v, roughness):
    """NRD_SH_ResolveSpecular (NRD.hlsli:1124-1133)."""
    nov = torch.abs(nm.dot(n, v))
    f = nm.get_specular_dominant_factor(nov, roughness)
    d = nm.normalize(nm.lerp(n, nm.reflect(-v, n), f[..., None]))
    y = nm.dot(d, sh.c1) + 0.5 * sh.c0
    return _ycocg_to_linear_corrected(y, sh.c0, sh.chroma)
