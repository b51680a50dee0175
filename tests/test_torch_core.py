"""rsn_torch.core against rsn.core: the same numpy inputs through both
packages, fp32.  Tolerance rtol 1e-5 / atol 1e-6 (fp32 rounding of
different summation orders and transcendental implementations) unless a
test states otherwise."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsn.core import contract as jcontract
from rsn.core import encodings as jenc
from rsn.core import rays as jrays
from rsn.core import render as jrender
from rsn.core import sampling as jsampling
from rsn.core import spacing as jspacing
from rsn_torch.core import contract as tcontract
from rsn_torch.core import encodings as tenc
from rsn_torch.core import rays as trays
from rsn_torch.core import render as trender
from rsn_torch.core import sampling as tsampling
from rsn_torch.core import spacing as tspacing
from torch_parity import bundles, n, random_rays, t

RTOL, ATOL = 1e-5, 1e-6


def close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(n(a), np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _weights(rng, R=6, S=10):
    w = rng.uniform(0.0, 0.3, size=(R, S, 1)).astype(np.float32)
    w[0] = 0.0                        # zero-weight ray
    w[1, :, 0] = 0.0
    w[1, 2, 0] = 1.0                  # all weight in one bin
    w[2, :, 0] = 0.02                 # never reaches 0.5 (depth clamp)
    return w


# ---- render -------------------------------------------------------------

@pytest.mark.parametrize("bg", ["white", "none", "per_ray"])
def test_render_rgb(rng, bg):
    R, S = 6, 10
    w = _weights(rng, R, S)
    rgb = rng.uniform(-0.2, 1.2, size=(R, S, 3)).astype(np.float32)
    rgb[3, 4, 1] = np.nan
    bgc = {"white": np.ones(3, np.float32), "none": None,
           "per_ray": rng.uniform(size=(R, 3)).astype(np.float32)}[bg]
    for training in (False, True):
        if training and bg != "none":
            continue
        ref = jrender.render_rgb(jnp.asarray(rgb), jnp.asarray(w),
                                 None if bgc is None else jnp.asarray(bgc),
                                 training=training)
        got = trender.render_rgb(t(rgb), t(w),
                                 None if bgc is None else t(bgc),
                                 training=training)
        close(got, ref, msg=f"training={training}")
        planes = [t(rgb[..., c]) for c in range(3)]
        ref_p = jrender.render_rgb_planes(
            jnp.asarray(w[..., 0]), [jnp.asarray(rgb[..., c])
                                     for c in range(3)],
            None if bgc is None else jnp.asarray(bgc), training=training)
        got_p = trender.render_rgb_planes(
            t(w[..., 0]), planes, None if bgc is None else t(bgc),
            training=training)
        close(got_p, ref_p, msg=f"planes training={training}")


def test_weights_accumulation_and_planes(rng):
    R, S = 5, 12
    starts = np.sort(rng.uniform(2, 6, size=(R, S + 1)), axis=-1).astype(
        np.float32)
    dens = rng.uniform(0, 5, size=(R, S, 1)).astype(np.float32)
    rs_j = jrays.RaySamples(
        origins=None, directions=None, starts=jnp.asarray(starts[:, :-1, None]),
        ends=jnp.asarray(starts[:, 1:, None]), pixel_area=None,
        spacing_starts=None, spacing_ends=None)
    rs_t = trays.RaySamples(
        origins=None, directions=None, starts=t(starts[:, :-1, None]),
        ends=t(starts[:, 1:, None]), pixel_area=None,
        spacing_starts=None, spacing_ends=None)
    wj = rs_j.get_weights(jnp.asarray(dens))
    wt = rs_t.get_weights(t(dens))
    close(wt, wj)
    deltas = starts[:, 1:] - starts[:, :-1]
    close(trender.weights_planes(t(dens[..., 0]), t(deltas)),
          jrender.weights_planes(jnp.asarray(dens[..., 0]),
                                 jnp.asarray(deltas)))
    close(trender.render_accumulation(wt), jrender.render_accumulation(wj))
    vals = rng.normal(size=(R, S, 3)).astype(np.float32)
    close(trender.render_normals(t(vals), wt),
          jrender.render_normals(jnp.asarray(vals), wj), atol=1e-5)
    close(trender.render_scalar(t(vals[..., :1]), wt),
          jrender.render_scalar(jnp.asarray(vals[..., :1]), wj), atol=1e-5)
    got = trender.composite_planes(t(dens[..., 0]), t(vals[..., 0]),
                                   t(vals[..., 1]))
    ref = jrender.composite_planes(jnp.asarray(dens[..., 0]),
                                   jnp.asarray(vals[..., 0]),
                                   jnp.asarray(vals[..., 1]))
    for a, b in zip(got, ref):
        close(a, b, atol=1e-5)


def test_render_depth_median_with_clamp(rng):
    R, S = 6, 10
    w = _weights(rng, R, S)
    bins = np.sort(rng.uniform(2, 6, size=(R, S + 1)), axis=-1).astype(
        np.float32)
    st, en = bins[:, :-1, None], bins[:, 1:, None]
    ref = jrender.render_depth_median(jnp.asarray(w), jnp.asarray(st),
                                      jnp.asarray(en))
    got = trender.render_depth_median(t(w), t(st), t(en))
    close(got, ref)
    # rays 0 and 2 never reach 0.5: clamped to the last midpoint
    np.testing.assert_allclose(n(got)[[0, 2], 0],
                               (st[[0, 2], -1, 0] + en[[0, 2], -1, 0]) / 2)
    close(trender.render_depth_median_planes(t(w[..., 0]), t(st[..., 0]),
                                             t(en[..., 0])),
          jrender.render_depth_median_planes(
              jnp.asarray(w[..., 0]), jnp.asarray(st[..., 0]),
              jnp.asarray(en[..., 0])))


def test_render_depth_expected_with_clamp(rng):
    """rtol 1e-5 / atol 1e-6; the zero-weight ray's 0 / eps clamps to the
    first midpoint, and a weight sum above 1 can push the mean past the
    last one."""
    R, S = 6, 10
    w = _weights(rng, R, S)
    w[3] *= 8.0
    bins = np.sort(rng.uniform(2, 6, size=(R, S + 1)), axis=-1).astype(
        np.float32)
    st, en = bins[:, :-1, None], bins[:, 1:, None]
    ref = jrender.render_depth_expected(jnp.asarray(w), jnp.asarray(st),
                                        jnp.asarray(en))
    got = trender.render_depth_expected(t(w), t(st), t(en))
    assert got.shape == (R, 1)
    close(got, ref)
    np.testing.assert_allclose(n(got)[0, 0], (st[0, 0, 0] + en[0, 0, 0]) / 2)


def test_normalize_and_safe_sqrt(rng):
    v = rng.normal(size=(7, 3)).astype(np.float32)
    v[0] = 0.0
    close(trender.normalize(t(v)), jrender.normalize(jnp.asarray(v)))
    x = rng.uniform(0, 4, size=(9,)).astype(np.float32)
    x[0] = 0.0
    close(trender.safe_sqrt(t(x)), jrender.safe_sqrt(jnp.asarray(x)))


# ---- rays ---------------------------------------------------------------

def test_gaussian_blob_and_cov_diag(rng):
    R, S = 4, 6
    o, d, pa = random_rays(rng, R)
    jb, tb = bundles(o, d, pa)
    rs_j = jspacing.spaced_sample(jb, jspacing.identity_spacing(), S)
    rs_t = tspacing.spaced_sample(tb, tspacing.identity_spacing(), S)
    bj, bt = jrays.get_gaussian_blob(rs_j), trays.get_gaussian_blob(rs_t)
    for name in ("mean", "dir_variance", "radius_variance"):
        close(getattr(bt, name), getattr(bj, name), atol=1e-6, msg=name)
    fj = jrays.conical_frustum_to_factored(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(np.full((R, 1), 2.5)),
        jnp.asarray(np.full((R, 1), 2.6)), jnp.asarray(np.sqrt(pa)))
    ft = trays.conical_frustum_to_factored(
        t(o), t(d), t(np.full((R, 1), 2.5)), t(np.full((R, 1), 2.6)),
        t(np.sqrt(pa)))
    close(ft.mean, fj.mean)
    close(ft.radius_variance, fj.radius_variance, atol=1e-12)


def test_conical_frustum_to_gaussian_dense_cov(rng):
    """The dense-covariance oracle: mean atol 1e-6, covariance atol 1e-9
    (its entries are ~1e-6 for these frusta)."""
    R, S = 5, 7
    o, d, pa = random_rays(rng, R)
    d[0] *= 2.0  # a direction that is not unit length
    st = np.sort(rng.uniform(2, 6, size=(R, S, 1)), axis=1).astype(
        np.float32)
    en = (st + rng.uniform(0.01, 0.3, size=(R, S, 1))).astype(np.float32)
    rad = np.broadcast_to(np.sqrt(pa)[:, None], (R, S, 1)).astype(np.float32)
    ob = np.broadcast_to(o[:, None], (R, S, 3)).astype(np.float32)
    db = np.broadcast_to(d[:, None], (R, S, 3)).astype(np.float32)
    mj, cj = jrays.conical_frustum_to_gaussian(*map(jnp.asarray,
                                                    (ob, db, st, en, rad)))
    mt, ct = trays.conical_frustum_to_gaussian(*map(t, (ob, db, st, en,
                                                        rad)))
    assert ct.shape == (R, S, 3, 3)
    close(mt, mj)
    close(ct, cj, atol=1e-9)
    # its diagonal is the factored blob's cov diagonal
    blob = trays.conical_frustum_to_factored(*map(t, (ob, db, st, en, rad)))
    dv, rv, dd = blob.dir_variance, blob.radius_variance, blob.directions
    dmag2 = (dd ** 2).sum(-1, keepdim=True)
    close(torch.diagonal(ct, dim1=-2, dim2=-1),
          n(dv * dd * dd + rv * (1.0 - dd * dd / dmag2)), atol=1e-12)


# ---- spacing + sampling -------------------------------------------------

@pytest.mark.parametrize("kind", ["identity", "reciprocal"])
def test_spaced_sample_eval(rng, kind):
    R, S = 5, 16
    o, d, pa = random_rays(rng, R)
    near, far = (2.0, 6.0) if kind == "identity" else (0.0, 256.0)
    jb, tb = bundles(o, d, pa, near, far)
    sj = (jspacing.identity_spacing() if kind == "identity"
          else jspacing.reciprocal_spacing(0.25))
    st = (tspacing.identity_spacing() if kind == "identity"
          else tspacing.reciprocal_spacing(0.25))
    rj = jspacing.spaced_sample(jb, sj, S)
    rt = tspacing.spaced_sample(tb, st, S)
    for name in ("starts", "ends", "spacing_starts", "spacing_ends",
                 "origins", "directions", "pixel_area"):
        close(getattr(rt, name), getattr(rj, name), msg=name)
    s = rng.uniform(size=(R, 7)).astype(np.float32)
    close(tspacing.spacing_to_euclidean(st, tb, t(s)),
          jspacing.spacing_to_euclidean(sj, jb, jnp.asarray(s)))


def test_stratify_bins_stays_between_centres():
    bins = torch.linspace(0.0, 1.0, 9).expand(4, 9)
    g = torch.Generator().manual_seed(3)
    out = tspacing.stratify_bins(bins, 4, g)
    centers = (bins[:, 1:] + bins[:, :-1]) / 2
    assert torch.all(out[:, 1:-1] >= centers[:, :-1])
    assert torch.all(out[:, 1:-1] <= centers[:, 1:])
    assert torch.all(out[:, 0] <= centers[:, 0])
    again = tspacing.stratify_bins(bins, 4, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)


@pytest.mark.parametrize("kind", ["identity", "reciprocal"])
def test_pdf_sample_bins_match(rng, kind):
    R, S, U = 6, 10, 12
    o, d, pa = random_rays(rng, R)
    near, far = (2.0, 6.0) if kind == "identity" else (0.0, 256.0)
    jb, tb = bundles(o, d, pa, near, far)
    sj = (jspacing.identity_spacing() if kind == "identity"
          else jspacing.reciprocal_spacing(0.25))
    st = (tspacing.identity_spacing() if kind == "identity"
          else tspacing.reciprocal_spacing(0.25))
    rj = jspacing.spaced_sample(jb, sj, S)
    rt = tspacing.spaced_sample(tb, st, S)
    w = _weights(rng, R, S)
    w[3, :, 0] = 0.0
    w[3, 0, 0] = 1e6  # cdf rounds to 1.0 before the last bin (clamped tail)
    pj = jsampling.pdf_sample(jb, rj, jnp.asarray(w), sj, U)
    pt = tsampling.pdf_sample(tb, rt, t(w), st, U)
    close(pt.spacing_starts, pj.spacing_starts, msg="spacing bins")
    close(pt.spacing_ends, pj.spacing_ends, msg="spacing bins")
    rtol = RTOL if kind == "identity" else 1e-4  # t(s) = s/(tan(1-s))
    close(pt.starts, pj.starts, rtol=rtol, msg="euclidean starts")
    close(pt.ends, pj.ends, rtol=rtol, msg="euclidean ends")


# ---- contraction ----------------------------------------------------------

def test_contract_blob_and_packed_planes(rng):
    R, S = 5, 8
    o, d, pa = random_rays(rng, R)
    o[0] *= 0.1  # samples inside the unit ball too
    jb, tb = bundles(o, d, pa, 0.0, 8.0)
    rj = jspacing.spaced_sample(jb, jspacing.identity_spacing(), S)
    rt = tspacing.spaced_sample(tb, tspacing.identity_spacing(), S)
    mj, cj = jcontract.contract_blob(jrays.get_gaussian_blob(rj))
    mt, ct = tcontract.contract_blob(trays.get_gaussian_blob(rt))
    close(mt, mj)
    close(ct, cj, atol=1e-9)
    pj = jcontract.packed_contract_planes(rj, 16)
    pt = tcontract.packed_contract_planes(rt, 16)
    assert pt.shape == (R * S, 16) and pt.dtype == torch.float32
    close(pt[:, :3], pj[:, :3])
    close(pt[:, 3:6], pj[:, 3:6], atol=1e-9)
    assert torch.all(pt[:, 6:] == 0)


def test_contract_dense_cov(rng):
    """The dense-covariance contraction: mean rtol 1e-5 / atol 1e-6,
    covariance atol 1e-9 (entries ~1e-6); inside the unit ball the
    identity; a negative diagonal entry is ReLU-clamped."""
    R, S = 5, 8
    o, d, pa = random_rays(rng, R)
    o[0] *= 0.1  # samples inside the unit ball too
    jb, tb = bundles(o, d, pa, 0.0, 8.0)
    rj = jspacing.spaced_sample(jb, jspacing.identity_spacing(), S)
    rt = tspacing.spaced_sample(tb, tspacing.identity_spacing(), S)
    bj = jrays.get_gaussian_blob(rj)
    bt = trays.get_gaussian_blob(rt)
    mean, cov = n(bt.mean), n(bt.dense_cov())
    close(cov, bj.dense_cov(), atol=1e-12)
    cov[1, 2] -= 2.0 * np.eye(3, dtype=np.float32) * cov[1, 2].max()
    mj, cj = jcontract.contract(jnp.asarray(mean), jnp.asarray(cov))
    mt, ct = tcontract.contract(t(mean), t(cov))
    assert ct.shape == (R, S, 3, 3)
    close(mt, mj)
    close(ct, cj, atol=1e-9)
    inside = np.linalg.norm(mean, axis=-1) <= 1.0
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(n(mt)[inside], mean[inside])
    assert (np.diagonal(n(ct), axis1=-2, axis2=-1) >= 0).all()
    # elsewhere its diagonal is contract_blob's
    keep = np.ones((R, S), bool)
    keep[1, 2] = False
    close(np.diagonal(n(ct), axis1=-2, axis2=-1)[keep],
          n(tcontract.contract_blob(bt)[1])[keep], atol=1e-9)


# ---- encodings --------------------------------------------------------------

def test_band_slices_match():
    assert tenc._BAND_SLICES == jenc._BAND_SLICES
    assert (tenc.IPE_OUT_DIM, tenc.ISH_OUT_DIM) == (jenc.IPE_OUT_DIM,
                                                    jenc.ISH_OUT_DIM)


@pytest.mark.parametrize("with_cov", [True, False])
def test_ipe_encode(rng, with_cov):
    mean = rng.uniform(-2, 2, size=(64, 3)).astype(np.float32)
    cov = rng.uniform(1e-4, 1e-1, size=(64, 3)).astype(np.float32)
    ref = jenc.ipe_encode(jnp.asarray(mean),
                          jnp.asarray(cov) if with_cov else None)
    got = tenc.ipe_encode(t(mean), t(cov) if with_cov else None)
    assert got.shape == (64, 99)
    # the top octaves' phases reach 2 pi 2^16 |mean| ~ 1e6 rad: this holds
    # only because both packages build the same fp32 frequencies and
    # arguments and take an accurate sine of them
    close(got, ref)


@pytest.mark.parametrize("quirk", [True, False])
def test_sh_basis_and_ish(rng, quirk):
    d = rng.normal(size=(32, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rough = rng.uniform(0, 2, size=(32, 1)).astype(np.float32)
    close(tenc.sh_basis(t(d), quirk), jenc.sh_basis(jnp.asarray(d), quirk),
          atol=1e-5)
    close(tenc.ish_encode(t(d), t(rough), quirk),
          jenc.ish_encode(jnp.asarray(d), jnp.asarray(rough), quirk),
          atol=1e-5)
    # the quirk doubles exactly the l=8, m=+-7 components
    diff = n(tenc.sh_basis(t(d), True)) - n(tenc.sh_basis(t(d), False))
    changed = np.any(np.abs(diff) > 0, axis=0)
    assert changed.sum() == 2
