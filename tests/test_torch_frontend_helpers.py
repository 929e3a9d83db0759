"""The frontend's material, hit-distance, BRDF and re-jitter helpers of the port
(`nrdtpu_torch/frontend.py`) against `nrdtpu/frontend.py` on seeded inputs, rtol 1e-5:
`material_factors`, `reblur_get_hit_dist`, the BRDF terms `_pow5`, `_fresnel_term`,
`_distribution_term`, `_diffuse_term` and `compute_brdfs`, `sg_rejitter` (with cases where each
of its four neighbour tests fails, and one where all pass) and `is_valid_radiance`.

Run alone: python -m pytest tests/test_torch_frontend_helpers.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrdtpu import frontend as jfe

from nrdtpu_torch import frontend as tfe

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (12, 10)


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _both(fn_name, *args):
    """(port, JAX) of the helper on the same numpy arguments, as numpy."""
    t = getattr(tfe, fn_name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                for a in args])
    j = getattr(jfe, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                for a in args])
    conv = (lambda r: tuple(np.asarray(x) for x in r)) if isinstance(t, tuple) else np.asarray
    return conv(t), conv(j)


def _close(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


def test_constants():
    assert tfe.NRD_MATERIAL_FACTOR_MIN_SCALE == jfe.NRD_MATERIAL_FACTOR_MIN_SCALE
    assert tfe.NRD_ROUGHNESS_FACTOR_MIN_SCALE == jfe.NRD_ROUGHNESS_FACTOR_MIN_SCALE
    assert tfe.NRD_REJITTER_VIEWZ_THRESHOLD == jfe.NRD_REJITTER_VIEWZ_THRESHOLD


def test_material_factors(rng):
    n, v = _unit(rng, SHAPE), _unit(rng, SHAPE)
    albedo = rng.uniform(0, 1, SHAPE + (3,)).astype(np.float32)
    rf0 = rng.uniform(0, 1, SHAPE + (3,)).astype(np.float32)
    rough = rng.uniform(0, 1, SHAPE).astype(np.float32)
    _close(*_both("material_factors", n, v, albedo, rf0, rough))


def test_reblur_get_hit_dist(rng):
    nhd = rng.uniform(0, 1, SHAPE).astype(np.float32)
    vz = rng.uniform(0.1, 50, SHAPE).astype(np.float32)
    rough = rng.uniform(0, 1, SHAPE).astype(np.float32)
    hdp = (3.0, 0.1, 20.0, -25.0)
    got = tfe.reblur_get_hit_dist(torch.from_numpy(nhd), torch.from_numpy(vz), hdp,
                                  torch.from_numpy(rough)).numpy()
    want = np.asarray(jfe.reblur_get_hit_dist(jnp.asarray(nhd), jnp.asarray(vz),
                                              jnp.asarray(hdp, jnp.float32), jnp.asarray(rough)))
    _close(got, want)
    # round trip through the normalization (where it does not saturate)
    norm = tfe.reblur_get_norm_hit_dist(torch.from_numpy(got), torch.from_numpy(vz), hdp,
                                        torch.from_numpy(rough)).numpy()
    np.testing.assert_allclose(norm, nhd, rtol=1e-5, atol=1e-6)


def test_brdf_terms(rng):
    x = rng.uniform(-0.2, 1.2, SHAPE).astype(np.float32)
    rough = rng.uniform(0, 1, SHAPE).astype(np.float32)
    nol, nov, voh = (rng.uniform(0, 1, SHAPE).astype(np.float32) for _ in range(3))
    rf0 = rng.uniform(0, 1, SHAPE).astype(np.float32)
    _close(*_both("_pow5", x))
    _close(*_both("_fresnel_term", rf0, voh))
    _close(*_both("_distribution_term", rough, nol))
    _close(*_both("_diffuse_term", rough, nol, nov, voh))


def test_compute_brdfs(rng):
    ld, ls, n, v = (_unit(rng, SHAPE) for _ in range(4))
    rf0 = rng.uniform(0, 1, SHAPE).astype(np.float32)
    rough = rng.uniform(0.05, 1, SHAPE).astype(np.float32)
    _close(*_both("compute_brdfs", ld, ls, n, v, rf0, rough))


# sg_rejitter's neighbour tests: east, west, north, south; each case fails one of them, by depth
# or by normal, or none ("all")
REJITTER_CASES = ["all", "east_z", "west_z", "north_normal", "south_normal"]


@pytest.mark.parametrize("case", REJITTER_CASES)
def test_sg_rejitter(rng, case):
    n = _unit(rng, SHAPE)
    v = _unit(rng, SHAPE)
    v = np.where((n * v).sum(-1, keepdims=True) < 0, -v, v).astype(np.float32)
    z = rng.uniform(1, 20, SHAPE).astype(np.float32)
    # neighbours on the centre's surface: depths within the threshold, normals close to n
    zs = {d: (z * (1.0 + rng.uniform(-1e-3, 1e-3, SHAPE))).astype(np.float32)
          for d in ("e", "w", "n", "s")}
    ns = {d: _unit_near(rng, n) for d in ("e", "w", "n", "s")}
    side, kind = (None, None) if case == "all" else case.split("_")
    if kind == "z":
        zs[side[0]] = (z * 1.5).astype(np.float32)
    elif kind == "normal":
        ns[side[0]] = (-n).astype(np.float32)
    rf0 = rng.uniform(0, 1, SHAPE + (3,)).astype(np.float32)
    # roughness >= 0.25: at the GGX peak of a lower roughness (noh -> 1) the distribution term's
    # t = (noh m^4 - noh) noh + 1 -> 0 turns the last-bit difference of XLA's and PyTorch's
    # rsqrt in noh into ~1e-3 of the jacobian (roughness 0.069: 1.4e-3); one pixel at 0,
    # below NRD_ROUGHNESS_EPS, away from its peak
    rough = rng.uniform(0.25, 1, SHAPE).astype(np.float32)
    rough[0, 0] = 0.0
    sgs = {}
    for sig in ("diff", "spec"):  # each signal's SG, the same numbers in both packages
        rad = rng.uniform(0, 2, SHAPE + (3,)).astype(np.float32)
        d = _unit(rng, SHAPE)
        nhd = rng.uniform(0, 1, SHAPE).astype(np.float32)
        sgs[sig] = [mod.sg_create(cast(rad), cast(d), cast(nhd))
                    for mod, cast in ((tfe, torch.from_numpy), (jfe, jnp.asarray))]
    args = (rf0, v, rough, z, zs["e"], zs["w"], zs["n"], zs["s"], n, ns["e"], ns["w"], ns["n"],
            ns["s"])
    got = tfe.sg_rejitter(sgs["diff"][0], sgs["spec"][0],
                          *[torch.from_numpy(a) for a in args]).numpy()
    want = np.asarray(jfe.sg_rejitter(sgs["diff"][1], sgs["spec"][1],
                                      *[jnp.asarray(a) for a in args]))
    _close(got, want)
    if case == "all":
        # where every test passes the jacobian bites (it is 1 where a lobe is below the surface)
        assert (got != 1.0).mean() > 0.25
    else:
        assert np.all(got == 1.0), case  # one failed test: the jacobian is 1


def _unit_near(rng, n):
    v = n + rng.normal(scale=0.05, size=n.shape).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_is_valid_radiance(rng):
    r = rng.uniform(0, 1, SHAPE + (3,)).astype(np.float32)
    r[0, 0, 1] = np.nan
    r[1, 2, 0] = np.inf
    r[2, 3, 2] = -np.inf
    got, want = _both("is_valid_radiance", r)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == r[..., 0].size - 3
