"""Math foundation of the PyTorch port - the subset of `nrdtpu/math.py` the REBLUR and SIGMA
slices call.

Every function keeps the op order of its JAX counterpart, so that float32 results agree
with the XLA reference path to the last bits wherever the ops themselves are exact
(+, -, *, /, sqrt, floor). Tensor functions take `(..., C)` or plane tensors on any device;
the scalar helpers at the top (weyl1d, bayer4x4, get_rotator, combine_rotators) are the
host-side numpy math of the per-frame constants (`camera.FrameMath`).
"""

from __future__ import annotations

import numpy as np
import torch

PI = float(np.pi)
EPS = 1e-6

# ---------------------------------------------------------------------------
# Host-side scalar helpers (float32 numpy, as the JAX package evaluates them)
# ---------------------------------------------------------------------------

_GOLDEN_CONJ = 0.6180339887498949


def weyl1d(seed: float, n) -> np.float32:
    """Sequence::Weyl1D - frac(seed + n / phi) in float32."""
    return np.mod(np.float32(seed) + np.float32(n) * np.float32(_GOLDEN_CONJ), np.float32(1.0))


def _reverse_bits_4(x: int) -> int:
    x = int(x) & 0xF
    return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)


def bayer4x4(pixel_pos, frame_index) -> np.float32:
    """Sequence::Bayer4x4 at one pixel (closed form of the 4x4 Bayer matrix)."""
    px, py = int(pixel_pos[0]) & 3, int(pixel_pos[1]) & 3
    pxy = px ^ py
    base = ((pxy & 1) << 3) | ((py & 1) << 2) | (((pxy >> 1) & 1) << 1) | ((py >> 1) & 1)
    return np.float32((base + _reverse_bits_4(frame_index)) & 15) / np.float32(16.0)


def bayer4x4_planes(h: int, w: int, frame_index, device=None):
    """bayer4x4 at every pixel of an (h, w) rect, float32 (h, w)."""
    px = torch.arange(w, device=device)[None, :] & 3
    py = torch.arange(h, device=device)[:, None] & 3
    pxy = px ^ py
    base = ((pxy & 1) << 3) | ((py & 1) << 2) | (((pxy >> 1) & 1) << 1) | ((py >> 1) & 1)
    return ((base + _reverse_bits_4(frame_index)) & 15).to(torch.float32) / 16.0


def checkerboard(px, py, frame_index):
    """Sequence::CheckerBoard (`nrdtpu/math.py:189`): the 0 / 1 checker pattern that flips
    every frame, (px + py + frame_index) & 1; px, py integer tensors, frame_index a host
    integer. A pixel has data under checkerboard mode m where this equals int(m) - 1."""
    return (px + py + int(frame_index)) & 1


def checkerboard_has_data(h: int, w: int, frame_index, mode: int, device=None, row0: int = 0):
    """(h, w) bool: the pixels that carry data this frame under checkerboard mode `mode`
    (1 BLACK, 2 WHITE), `nrdtpu/passes/reblur/denoiser.py:189-195`; the rows are the frame rows
    row0 .. row0 + h - 1."""
    px = torch.arange(w, device=device)[None, :]
    py = torch.arange(row0, row0 + h, device=device)[:, None]
    return checkerboard(px, py, frame_index) == int(mode) - 1


# ---------------------------------------------------------------------------
# Hash RNG (Rng::Hash, PCG) - uint32 arithmetic emulated in int64
# ---------------------------------------------------------------------------
# PyTorch has no uint32 shifts on the CPU, so the state is an int64 tensor holding a value in
# [0, 2^32). Products are split so that none leaves int64: the stream is bit for bit the one
# of `nrdtpu.math.hash_*` and of the kernels' uint32 code (`kernels/csrc/common.cuh`).

_U32 = 0xFFFFFFFF


def _mul32(a, b: int):
    """(a * b) mod 2^32 for an int64 tensor a in [0, 2^32) and a constant b < 2^32."""
    return (a * (b & 0xFFFF) + ((a * (b >> 16)) & 0xFFFF) * 65536) & _U32


def hash_init(px, py, frame_index):
    """Rng::Hash::Initialize; px, py integer tensors, frame_index a host integer (taken
    mod 2^32, as a uint32 cast does). Returns the int64 state."""
    f = ((int(frame_index) & _U32) * 2798796415) & _U32
    state = _mul32(px.long(), 1597334677) ^ _mul32(py.long(), 3812015801) ^ f
    return (_mul32(state, 747796405) + 2891336453) & _U32


def hash_next(state):
    """One PCG step; returns (new_state, 32 random bits)."""
    state = (_mul32(state, 747796405) + 2891336453) & _U32
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return state, (word >> 22) ^ word


def hash_float(state):
    """Returns (new_state, float32 in [0, 1))."""
    state, bits = hash_next(state)
    return state, (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def hash_float2(state):
    state, a = hash_float(state)
    state, b = hash_float(state)
    return state, torch.stack([a, b], -1)


def get_rotator(angle) -> np.ndarray:
    a = np.float32(angle)
    ca, sa = np.cos(a), np.sin(a)
    return np.array([ca, sa, -sa, ca], np.float32)


def combine_rotators(r0, r1) -> np.ndarray:
    ca = r0[0] * r1[0] - r0[1] * r1[1]
    sa = r0[1] * r1[0] + r0[0] * r1[1]
    return np.array([ca, sa, -sa, ca], np.float32)


# ---------------------------------------------------------------------------
# Small numeric utilities
# ---------------------------------------------------------------------------


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lerp(a, b, t):
    return a + (b - a) * t


def div(x, s: float):
    """x / s as a true float32 division on every device. PyTorch's CUDA kernels turn a
    division by a Python scalar into a multiplication by its reciprocal, which can move a
    value across a floor() that the XLA reference and the hand kernels do not cross."""
    return x / torch.full_like(x, s)


def smoothstep01(x):
    x = saturate(x)
    return x * x * (3.0 - 2.0 * x)


def smoothstep(a, b, x):
    t = saturate((x - a) / (b - a))
    return t * t * (3.0 - 2.0 * t)


def pow01(x, y):
    """Math::Pow01: pow of the saturated base (a tensor or float exponent)."""
    return torch.pow(saturate(x), y)


def linearstep(a, b, x):
    return saturate((x - a) / (b - a))


def acos_approx(x):
    """Math::AcosApprox as the JAX package defines it (|x|-polynomial form)."""
    x = torch.clamp(x, -1.0, 1.0)
    res = torch.sqrt(saturate(1.0 - torch.abs(x))) * (PI / 2.0)
    return torch.where(x >= 0.0, res, PI - res)


def rsqrt_safe(x):
    return torch.rsqrt(torch.clamp_min(x, 1e-15))


def safe_normalize(v):
    """_NRD_SafeNormalize (NRD.hlsli:321-324) over the last axis."""
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-9)


def normalize(v):
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v, dim=-1, keepdim=True), 1e-15))


def length(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 0.0))


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def reflect(i, n):
    """HLSL reflect over the last axis: i - 2 dot(n, i) n."""
    return i - 2.0 * dot(n, i)[..., None] * n


_LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb):
    """_NRD_Luminance (NRD.hlsli:350-354) over the last axis."""
    w = torch.tensor(_LUMA, dtype=torch.float32, device=rgb.device)
    return dot(rgb, w)


def get_std_dev(m1, m2):
    return torch.sqrt(torch.abs(m2 - m1 * m1))


# ---------------------------------------------------------------------------
# 2D rotators (Geometry::ScaleRotator)
# ---------------------------------------------------------------------------


def scale_rotator(rotator, scale):
    """rotator (..., 4), scale (..., 2): output x gets scale[0], output y gets scale[1]."""
    return torch.stack([rotator[..., 0] * scale[..., 0], rotator[..., 1] * scale[..., 1],
                        rotator[..., 2] * scale[..., 0], rotator[..., 3] * scale[..., 1]], -1)


def rotate_vector2(rotator, v):
    """Apply a rotator (..., 4) to a host 2-vector (x, y), as a Poisson tap offset is."""
    vx, vy = float(v[0]), float(v[1])
    return torch.stack([vx * rotator[..., 0] + vy * rotator[..., 2],
                        vx * rotator[..., 1] + vy * rotator[..., 3]], -1)


# ---------------------------------------------------------------------------
# Color codecs (NRD.hlsli:356-375)
# ---------------------------------------------------------------------------


def linear_to_ycocg(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.25 * r + 0.5 * g + 0.25 * b
    co = 0.5 * r - 0.5 * b
    cg = -0.25 * r + 0.5 * g - 0.25 * b
    return torch.stack([y, co, cg], -1)


def ycocg_to_linear(ycocg):
    y, co, cg = ycocg[..., 0], ycocg[..., 1], ycocg[..., 2]
    t = y - cg
    g = y + cg
    r = t + co
    b = t - co
    return torch.clamp_min(torch.stack([r, g, b], -1), 0.0)


# ---------------------------------------------------------------------------
# Octahedral unit-vector codec (NRD.hlsli:327-347)
# ---------------------------------------------------------------------------


def _sign_ge0(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def encode_unit_vector(v, signed: bool):
    """_NRD_EncodeUnitVector; the |x|+|y|+|z| sum is taken left to right."""
    a = torch.abs(v)
    v = v / torch.clamp_min((a[..., 0:1] + a[..., 1:2]) + a[..., 2:3], 1e-15)
    sgn = _sign_ge0(v[..., :2])
    oct_wrap = (1.0 - torch.abs(torch.flip(v[..., :2], dims=(-1,)))) * sgn
    xy = torch.where(v[..., 2:3] >= 0.0, v[..., :2], oct_wrap)
    return xy if signed else xy * 0.5 + 0.5


def decode_unit_vector(p, signed: bool, do_normalize: bool = True):
    p = p if signed else p * 2.0 - 1.0
    z = 1.0 - torch.abs(p[..., 0]) - torch.abs(p[..., 1])
    t = saturate(-z)
    xy = p - t[..., None] * _sign_ge0(p)
    n = torch.cat([xy, z[..., None]], -1)
    return normalize(n) if do_normalize else n


def quantize_unorm(x, bits: int):
    scale = float((1 << bits) - 1)
    return torch.round(saturate(x) * scale) / scale


def quantize_snorm(x, bits: int):
    scale = float((1 << (bits - 1)) - 1)
    return torch.round(torch.clamp(x, -1.0, 1.0) * scale) / scale


# ---------------------------------------------------------------------------
# Filtering weights (MathLib Filtering::*)
# ---------------------------------------------------------------------------


def scale2(v, sx: float, sy: float):
    """(..., 2) tensor times a host 2-vector (per component, so no constant is copied to
    the device)."""
    return torch.stack([v[..., 0] * sx, v[..., 1] * sy], -1)


def bilinear_filter(uv, tex_size):
    """Returns (origin, frac) of the 2x2 footprint; tex_size is a host (w, h) pair."""
    pos = scale2(uv, float(tex_size[0]), float(tex_size[1])) - 0.5
    origin = torch.floor(pos)
    return origin, pos - origin


def bilinear_weights(f):
    fx, fy = f[..., 0], f[..., 1]
    return torch.stack([(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy], -1)


def get_bilinear_custom_weights(f, custom):
    return bilinear_weights(f) * custom


def apply_bilinear_custom_weights(s00, s10, s01, s11, w):
    """Weighted sum of 4 taps (..., C) renormalized; 0 where the weight sum is ~0."""
    out = s00 * w[..., 0:1] + s10 * w[..., 1:2] + s01 * w[..., 2:3] + s11 * w[..., 3:4]
    wsum = torch.sum(w, dim=-1, keepdim=True)
    small = wsum < 0.0001
    return torch.where(small, 0.0, out / torch.where(small, 1.0, wsum))


def catmull_rom_weights(f, sharpness: float = 0.5):
    c = sharpness
    w0 = f * (f * (-c * f + 2.0 * c) - c)
    w1 = f * (f * ((2.0 - c) * f - (3.0 - c))) + 1.0
    w2 = f * (f * (-(2.0 - c) * f + (3.0 - 2.0 * c)) + c)
    w3 = f * (f * (c * f - c))
    return w0, w1, w2, w3


# ---------------------------------------------------------------------------
# Sampling kernels (Common.hlsli:170-192) - (x, y, weight-arg) triples
# ---------------------------------------------------------------------------

_S3 = float(np.sqrt(3.0))
_S2 = float(np.sqrt(2.0))

SPECIAL_6 = np.array([
    (-0.50 * _S3, -0.50, 1.0),
    (0.00, 1.00, 1.0),
    (0.50 * _S3, -0.50, 1.0),
    (0.00, -0.30, 0.3),
    (0.15 * _S3, 0.15, 0.3),
    (-0.15 * _S3, 0.15, 0.3),
], np.float32)

SPECIAL_8 = np.array([
    (-1.00, 0.00, 1.0),
    (0.00, 1.00, 1.0),
    (1.00, 0.00, 1.0),
    (0.00, -1.00, 1.0),
    (-0.25 * _S2, 0.25 * _S2, 0.5),
    (0.25 * _S2, 0.25 * _S2, 0.5),
    (0.25 * _S2, -0.25 * _S2, 0.5),
    (-0.25 * _S2, -0.25 * _S2, 0.5),
], np.float32)


# ---------------------------------------------------------------------------
# Weight machinery (Common.hlsli:484-598)
# ---------------------------------------------------------------------------

NRD_EXP_WEIGHT_DEFAULT_SCALE = 3.0
NRD_MAX_PERCENT_OF_LOBE_VOLUME = 0.75


def normal_encoding_error(normal_encoding: int) -> float:
    """NRD_NORMAL_ENCODING_ERROR (Common.hlsli:76-85)."""
    if normal_encoding < 2:
        return 1.50 / 255.0
    if normal_encoding == 2:
        return 0.75 / 255.0
    return 0.50 / 255.0


def atan_approx(x):
    """Odd minimax atan polynomial with range reduction (the JAX package's atan)."""
    ax = torch.abs(x)
    hi = ax > 1.0
    a = torch.where(hi, 1.0 / torch.clamp_min(ax, 1e-30), ax)
    s = a * a
    p = a * (0.99988660 + s * (-0.33029950 + s * (0.18014100 + s * (
        -0.08513300 + s * 0.02083510))))
    r = torch.where(hi, (np.pi / 2.0) - p, p)
    return torch.where(x < 0.0, -r, r)


def pow01_quarter(x):
    """Math::Pow01(x, 0.25) as sqrt(sqrt(saturate(x)))."""
    return torch.sqrt(torch.sqrt(saturate(x)))


def get_specular_lobe_tan_half_angle(roughness, percent_of_volume):
    """percent_of_volume: a tensor or a host float (then evaluated in float32)."""
    m = roughness * roughness
    p = torch.as_tensor(percent_of_volume, dtype=torch.float32, device=m.device)
    return m * torch.sqrt(p / torch.clamp_min(1.0 - p, EPS))


def get_spec_magic_curve(roughness):
    """GetSpecMagicCurve (Common.hlsli:311-317) with the default power 0.25."""
    f = 1.0 - torch.exp2(-200.0 * roughness * roughness)
    return f * pow01_quarter(roughness)


def get_normal_weight_param(non_linear_accum_speed, lobe_angle_fraction, roughness,
                            encoding_error: float = 0.75 / 255.0):
    """GetNormalWeightParam (Common.hlsli:486-499). Returns 1/angle."""
    percent_of_volume = NRD_MAX_PERCENT_OF_LOBE_VOLUME * lerp(
        lobe_angle_fraction, 1.0, non_linear_accum_speed)
    tan_half = get_specular_lobe_tan_half_angle(roughness, percent_of_volume)
    angle = torch.clamp_min(atan_approx(tan_half), encoding_error)
    return 1.0 / angle


def get_hit_distance_weight_params(hit_dist, non_linear_accum_speed, roughness):
    """GetHitDistanceWeightParams (Common.hlsli:510-521). Returns (a, b)."""
    smc = get_spec_magic_curve(roughness)
    norm = lerp(0.0005, 1.0, torch.minimum(non_linear_accum_speed, smc))
    a = 1.0 / norm
    return a, -(hit_dist * a)


NRD_ROUGHNESS_SENSITIVITY = 0.01


def get_roughness_weight_params(roughness, fraction, sensitivity=NRD_ROUGHNESS_SENSITIVITY):
    """GetRoughnessWeightParams (Common.hlsli:523-529). Returns (a, b)."""
    a = 1.0 / lerp(sensitivity, 1.0, saturate(roughness * fraction))
    return a, -(roughness * a)


def get_relaxed_roughness_weight_params(m, fraction=1.0,
                                        sensitivity=NRD_ROUGHNESS_SENSITIVITY):
    """GetRelaxedRoughnessWeightParams (Common.hlsli:531-540); m = roughness^2."""
    a = 1.0 / lerp(sensitivity, 1.0, lerp(m * m, m, fraction))
    return a, -(m * a)


def compute_non_exponential_weight_with_sigma(x, px, py, sigma):
    """ComputeNonExponentialWeightWithSigma (Common.hlsli:562-563)."""
    return smoothstep(1.0, 0.0, torch.abs(x * px + py) - sigma * px)


def get_specular_dominant_factor(nov, roughness):
    """_NRD_GetSpecularDominantFactor (NRD.hlsli:386-392), G2-preintegrated fit."""
    a = 0.298475 * torch.log(39.4115 - 39.0029 * roughness)
    return saturate(torch.pow(saturate(1.0 - nov), 10.8649) * (1.0 - a) + a)


def get_specular_dominant_direction(n, v, roughness):
    """ImportanceSampling::GetSpecularDominantDirection over the last axis.
    Returns (..., 4): the normalized direction and the dominant factor."""
    nov = torch.abs(dot(n, v))
    f = get_specular_dominant_factor(nov, roughness)
    d = normalize(lerp(n, reflect(-v, n), f[..., None]))
    return torch.cat([d, f[..., None]], -1)


def get_basis(n):
    """Geometry::GetBasis (branchless ONB) over the last axis. Returns (t, b)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], -1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def rotate_vector_by_basis(t, b, n, v):
    """World -> local: the rows of the basis are (t, b, n)."""
    return torch.stack([dot(t, v), dot(b, v), dot(n, v)], -1)


def compute_exponential_weight(x, px, py):
    """exp(-3 |x px + py|) - the JAX package's ComputeExponentialWeight (true exp)."""
    return torch.exp(-NRD_EXP_WEIGHT_DEFAULT_SCALE * torch.abs(x * px + py))


def compute_weight(x, px, py):
    """ComputeNonExponentialWeight (Common.hlsli:559-560): SmoothStep(1, 0, |x px + py|)."""
    return smoothstep(1.0, 0.0, torch.abs(x * px + py))


def get_gaussian_weight(r: float) -> float:
    """GetGaussianWeight (Common.hlsli:571-574) of a static tap radius, in float32."""
    return float(torch.exp(torch.tensor(-0.66 * r * r, dtype=torch.float32)))


def get_geometry_weight_params(plane_dist_sensitivity, frustum_size, xv, nv):
    """GetGeometryWeightParams (Common.hlsli:501-508). Returns (a, b) with w = f(|d a + b|)."""
    a = 1.0 / (plane_dist_sensitivity * frustum_size)
    return a, -(dot(nv, xv) * a)


def get_encoding_aware_normal_weight(n_curr, n_prev, max_angle, curvature_angle,
                                     threshold_angle=0.0, remap=False):
    """GetEncodingAwareNormalWeight (Common.hlsli:578-589) over the last axis."""
    angle = acos_approx(dot(n_curr, n_prev))
    w = smoothstep01(1.0 - (angle - curvature_angle - threshold_angle) / max_angle)
    return smoothstep(0.05, 0.95, w) if remap else w


def apply_thin_lens_equation(o, curvature):
    """ApplyThinLensEquation (Common.hlsli:404-409)."""
    return o / (2.0 * curvature * o + 1.0)


def get_disocclusion_threshold(disocclusion_threshold, frustum_size, nov):
    return frustum_size * saturate(disocclusion_threshold / torch.clamp_min(nov, 0.01))


def pixel_radius_to_world(unproject, ortho_mode, pixel_radius, view_z):
    return pixel_radius * unproject * lerp(view_z, 1.0, abs(ortho_mode))


def get_frustum_size(min_rect_dim_mul_unproject, ortho_mode, view_z):
    return min_rect_dim_mul_unproject * lerp(view_z, 1.0, abs(ortho_mode))


def get_hit_dist_factor(hit_dist, frustum_size):
    return saturate(hit_dist / frustum_size)


# ---------------------------------------------------------------------------
# Geometry transforms (MathLib Geometry::*)
# ---------------------------------------------------------------------------


def get_screen_uv(m_world_to_clip, x):
    """World position (..., 3) -> [0,1]^2 uv (y down); m is a host (4, 4) matrix."""
    m = np.asarray(m_world_to_clip, np.float32)
    r = [[float(m[i, j]) for j in range(4)] for i in range(4)]
    cx = x[..., 0] * r[0][0] + x[..., 1] * r[0][1] + x[..., 2] * r[0][2] + r[0][3]
    cy = x[..., 0] * r[1][0] + x[..., 1] * r[1][1] + x[..., 2] * r[1][2] + r[1][3]
    cw = x[..., 0] * r[3][0] + x[..., 1] * r[3][1] + x[..., 2] * r[3][2] + r[3][3]
    cw = torch.where(torch.abs(cw) < 1e-15, 1e-15, cw)
    u = cx / cw * 0.5 + 0.5
    v = 0.5 - cy / cw * 0.5
    return torch.stack([u, v], -1)


def rotate_vector(m, v):
    """Rotation part of a host (4, 4) / (3, 3) matrix applied to (..., 3)."""
    m = np.asarray(m, np.float32)
    r = [[float(m[i, j]) for j in range(3)] for i in range(3)]
    return torch.stack([v[..., 0] * r[i][0] + v[..., 1] * r[i][1] + v[..., 2] * r[i][2]
                        for i in range(3)], -1)


def rotate_vector_transposed(m, v):
    """m[:3, :3]^T applied to (..., 3) - `v @ m[:3, :3]` in the JAX package."""
    return rotate_vector(np.asarray(m, np.float32)[:3, :3].T, v)


def affine_transform(m, p):
    m = np.asarray(m, np.float32)
    r = rotate_vector(m, p)
    return torch.stack([r[..., i] + float(m[i, 3]) for i in range(3)], -1)


def reconstruct_view_position(uv, frustum, view_z, ortho_mode=0.0):
    """Geometry::ReconstructViewPosition; frustum is the host (x0, y0, dx, dy)."""
    f = [float(v) for v in np.asarray(frustum, np.float32)]
    scale = lerp(view_z, 1.0, abs(float(ortho_mode)))
    x = (uv[..., 0] * f[2] + f[0]) * scale
    y = (uv[..., 1] * f[3] + f[1]) * scale
    return torch.stack([x, y, view_z], -1)
