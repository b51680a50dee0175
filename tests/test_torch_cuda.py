"""The port's CUDA kernels on the card: the wgmma / mma.sync probe that K1's
and K2's Hopper trunk rests on, shapes the smoke run does not
reach (ragged last tiles, K1 / K2 over more tiles than one block per SM,
odd samples per ray, every flag pair of the
training forward, K3 / K7 / K1 at the train width on the Hopper ring
against plain, each other and K10, bit for bit, and the pack launch of
their weight blob, K9 over ragged warp tiles, NaN rows and many tiles
per warp, K7 / K8 at ragged shapes, K10-K13 at ragged shapes and over
many tiles per block), K9 against its first design (the
RSN_K9_FIRST_DESIGN build) and K11 / K12 against theirs (the
RSN_K11_FIRST_DESIGN build, K12 also on an encoding with a non-zero tail)
bit for bit, the launch counters (one train
step on each route, camera off and on, the field API), K4 == K8 and K5 ==
K4 on K3's spill over several chunks,
determinism, the alignment checks, small renders (the default
method and the proposal preset) on both devices, the recompute route's
smaller peak memory, and the tools' experiments (K14-K16) against their
plain versions at ragged shapes, with v3i == v3u and v3F == v3L bit for
bit and K14 / K15 against their first design (the RSN_K14_FIRST_DESIGN
build) bit for bit, and the backward experiments (K17-K19): K17 against K8 and its plain
version, K18's four modes and K19 against theirs, K19 == K18's full mode
on K3's spill, K18 full + wgrad and K19 (kernel A + kernel B per chunk)
against their first design (the RSN_K18_FIRST_DESIGN build: dmc and dg
bit for bit, the weight gradients within 1e-4), and K13 and K17 (K8's
kernel A, or K17's 128-row one, and kernel B per chunk; K13's sum launch
== its plain version bit for bit) against their first design (the
RSN_K13_FIRST_DESIGN build: dmc bit for bit, K13's dg too, the rest
within 1e-4), with K17's weight matrices == K8's bit for bit.

Needs a CUDA card and nvcc; skipped without them.  This file imports no
jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from rsn_torch.configs import ModelConfig, PipelineConfig, TrainerConfig
from rsn_torch.data.synthetic import make_synthetic_cameras
from rsn_torch.engine.trainer import render_image
from rsn_torch.experiments import (bwd_ablate, bwd_noipe, bwd_whole,
                                   cheap_sin, interleave, interleave2)
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from rsn_torch.kernels import proposal_forward as pf
from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.kernels import wgrad_sm90 as wg
from rsn_torch.models.field import Field
from rsn_torch.models.proposal import ProposalField

pytestmark = pytest.mark.cuda
ATOL = 2e-2  # bf16 outputs: two ulps near 1


@pytest.fixture(scope="module")
def field():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return Field(torch.Generator().manual_seed(3)).cuda().eval()


def _inputs(R: int, S: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    n = R * S
    mc = torch.zeros(n, 16)
    mc[:, :3] = torch.rand(n, 3, generator=g) * 3.6 - 1.8
    mc[:, 3:6] = torch.rand(n, 3, generator=g) * 3e-3
    mc[: min(n, 8), 3:6] = 0.0  # undamped top octaves
    dirs = torch.nn.functional.normalize(torch.randn(R, 3, generator=g), dim=-1)
    return mc.cuda(), dirs.cuda()


@pytest.mark.parametrize("R,S", [(1, 1), (3, 29), (5, 64), (7, 200),
                                 (130, 128)])
def test_kernels_match_plain_versions(field, R, S):
    mc, dirs = _inputs(R, S)
    g = ff.mid_g_bands(field, dirs)
    p3, pd = ff.pack_params_v3f(field), ff.pack_params_density(field)
    k1 = ff.field_forward_v3(p3, mc, g, S)
    k2 = ff.field_forward_density(pd, mc)
    torch.cuda.synchronize()
    r1 = ff.field_forward_v3_plain(p3, mc, g, S)
    r2 = ff.field_forward_density_plain(pd, mc)
    assert k1.shape == (R * S, 16) and k2.shape == (R * S, 8)
    assert torch.isfinite(k1.float()).all()
    assert float((k1[:, :14].float() - r1[:, :14].float()).abs().max()) <= ATOL
    assert torch.all(k1[:, 14:] == 0)
    assert float((k2.float() - r2.float()).abs().max()) <= ATOL
    assert torch.equal(k2[:, 0], k1[:, ff.V3_DENSITY])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wgmma_probe_matches_mma_sync(field, seed):
    """One 64 x 256 x 256 bf16 layer through wgmma (the Hopper K1 / K2) and
    through mma.sync (trunk(), which K3 and the others keep): the fp32 sums
    agree bit for bit, and both are the product (against float64).  Seed 3
    spreads the exponents over 2^-12..2^12, so the sums round."""
    rng = np.random.default_rng(seed)
    if seed < 3:
        a = rng.standard_normal((64, 256))
        w = rng.standard_normal((256, 256)) * 0.06
    else:
        a = rng.standard_normal((64, 256)) * np.exp2(
            rng.integers(-12, 12, (64, 256)))
        w = rng.standard_normal((256, 256)) * np.exp2(
            rng.integers(-12, 12, (256, 256)))
    a = torch.tensor(a, dtype=torch.float32).to(torch.bfloat16).cuda()
    w = torch.tensor(w, dtype=torch.float32).to(torch.bfloat16).cuda()
    d_wgmma, d_mma = ts.mma_probe(a, w)
    torch.cuda.synchronize()
    assert torch.equal(d_wgmma.view(torch.int32), d_mma.view(torch.int32))
    ref = a.double() @ w.double()
    scale = float((a.double().abs() @ w.double().abs()).max())
    assert float((d_wgmma.double() - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("R,S", [(1, 100), (3, 43), (2, 64), (1, 128),
                                 (133, 128), (2500, 7), (300, 64)])
def test_render_kernels_ragged_and_persistent(field, R, S):
    """K1 and K2 on 128-row tiles of a persistent grid: fewer rows than a
    tile, a ragged last tile, S = 64, 128 and odd, more tiles than 132
    blocks (the loop over tiles wraps).  Each within ATOL of its plain
    version; K2's column 0 == K1's column 12 == K3's (trunk()) bit for bit;
    two calls give equal outputs."""
    mc, dirs = _inputs(R, S, seed=R + S)
    g = ff.mid_g_bands(field, dirs)
    p3, pd = ff.pack_params_v3f(field), ff.pack_params_density(field)
    k1 = ff.field_forward_v3(p3, mc, g, S)
    k2 = ff.field_forward_density(pd, mc)
    k3, _ = tft.field_forward_v6(p3, mc, g, S, False, False)
    again1 = ff.field_forward_v3(p3, mc, g, S)
    again2 = ff.field_forward_density(pd, mc)
    torch.cuda.synchronize()
    r1 = ff.field_forward_v3_plain(p3, mc, g, S)
    r2 = ff.field_forward_density_plain(pd, mc)
    assert torch.isfinite(k1.float()).all() and torch.all(k1[:, 14:] == 0)
    assert float((k1[:, :14].float() - r1[:, :14].float()).abs().max()) <= ATOL
    assert float((k2.float() - r2.float()).abs().max()) <= ATOL
    assert torch.equal(k2[:, 0], k1[:, ff.V3_DENSITY])
    assert torch.equal(k3[:, ff.V3_DENSITY], k1[:, ff.V3_DENSITY])
    assert torch.equal(again1, k1) and torch.equal(again2, k2)


def test_launch_counts_follow_kernel_launches(field):
    mc, dirs = _inputs(4, 16)
    g = ff.mid_g_bands(field, dirs)
    ff.reset_launch_counts()
    ff.field_forward_v3(ff.pack_params_v3f(field), mc, g, 16)
    ff.field_forward_density(ff.pack_params_density(field), mc)
    ff.field_forward_density(ff.pack_params_density(field), mc)
    ff.field_forward_density_plain(ff.pack_params_density(field), mc)
    torch.cuda.synchronize()
    assert {k: ff.LAUNCHES[k] for k in ("field_forward_v3",
                                        "field_forward_density")} == {
        "field_forward_v3": 1, "field_forward_density": 2}


def test_misaligned_operand_raises(field):
    mc, _ = _inputs(2, 32)
    packed = list(ff.pack_params_density(field))
    shifted = torch.empty(packed[16].numel() + 1, dtype=torch.bfloat16,
                          device="cuda")[1:].view_as(packed[16])
    shifted.copy_(packed[16])
    packed[16] = shifted
    with pytest.raises(ValueError, match="aligned"):
        ff.field_forward_density(packed, mc)


def _bf16_ulp_share(got, ref):
    """Share of entries within one bf16 ulp of the reference."""
    got, ref = got.float(), ref.float()
    ulp = ref.abs().clamp_min(1e-30) * 2.0 ** -7
    return float(((got - ref).abs() <= ulp).float().mean())


def _rel_err(got, ref):
    scale = max(float(ref.float().abs().max()), 1e-6)
    return float((got.float() - ref.float()).abs().max()) / scale


@pytest.mark.parametrize("R,S", [(1, 1), (3, 29), (5, 64), (33, 128)])
@pytest.mark.parametrize("normals,spill_x", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_train_kernels_match_plain_versions(field, R, S, normals, spill_x):
    """K3 with every flag pair, then K4 (acts) or K5 (xacts) on K3's
    output, against the plain versions on the same inputs."""
    mc, dirs = _inputs(R, S, seed=R)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3f(field)
    packed = tft.pack_params_v4f(p3, field) if normals else p3
    out, acts = tft.field_forward_v6(packed, mc, g, S, normals, spill_x)
    torch.cuda.synchronize()
    ref_out, ref_acts = tft.field_forward_v6_plain(packed, mc, g, S, normals,
                                                   spill_x)
    cols = list(range(14)) + list(range(17, 20))
    assert torch.isfinite(out.float()).all()
    assert float((out[:, cols].float() - ref_out[:, cols].float()).abs()
                 .max()) <= ATOL
    assert torch.equal(out[:, 12], ff.field_forward_v3(p3, mc, g, S)[:, 12])
    if normals:
        # against the plain dgrad on the kernel's own activations (the
        # whole plain forward may round a row's activations otherwise)
        chain = tft.normals_dgrad_plain(packed, tft._split_acts(acts), mc)
        unit = lambda v: -torch.nn.functional.normalize(v.float(), dim=-1)
        live = chain.norm(dim=-1) > 1e-3
        cos = (unit(out[:, 14:17]) * unit(chain)).sum(-1)[live]
        assert float(cos.min()) >= 0.999
    else:
        assert torch.all(out[:, 14:17] == 0)
    assert torch.all(out[:, 20:] == 0)
    assert acts.shape == ref_acts.shape
    assert _bf16_ulp_share(acts, ref_acts) >= 0.999

    gen = torch.Generator().manual_seed(S)
    d_out = torch.randn(R * S, tft.OUT_TRAIN, generator=gen)
    d_out[:, 14:] = 0.0
    d_out = d_out.to(torch.bfloat16).cuda()
    if spill_x:
        dg, dpk = tft.field_backward_v6(p3, g, acts, d_out, out, S)
        ref_dg, ref_dpk = tft.field_backward_v6_plain(p3, g, acts, d_out,
                                                      out, S)
    else:
        dmc, dg, dpk = tft.field_backward_v5(p3, mc, g, acts, d_out, out, S)
        _, ref_dg, ref_dpk = ref = tft.field_backward_v5_plain(
            p3, mc, g, acts, d_out, out, S)
        assert _rel_err(dmc, ref[0]) <= ATOL
    torch.cuda.synchronize()
    assert _rel_err(dg, ref_dg) <= ATOL
    for i, (a, b) in enumerate(zip(dpk, ref_dpk)):
        assert a.shape == b.shape, i
        assert _rel_err(a, b) <= ATOL, i


def test_train_launch_counts_and_determinism(field):
    mc, dirs = _inputs(6, 64)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3f(field)
    ff.reset_launch_counts()
    out, xacts = tft.field_forward_v6(tft.pack_params_v4f(p3, field), mc, g,
                                      64, True, True)
    _, acts = tft.field_forward_v6(p3, mc, g, 64)
    d_out = out.clone()
    runs = [tft.field_backward_v6(p3, g, xacts, d_out, out, 64)
            for _ in range(2)]
    tft.field_backward_v5(p3, mc, g, acts, d_out, out, 64)
    tft.field_backward_v6_plain(p3, g, xacts, d_out, out, 64)
    torch.cuda.synchronize()
    # one chunk per call (one ray of one tile per block): kernels A and B
    # once each
    assert {k: ff.LAUNCHES[k] for k in ("field_forward_v6",
                                        "field_backward_v5",
                                        "field_backward_v6",
                                        "field_backward_v4_wgrad")} == {
        "field_forward_v6": 2, "field_backward_v5": 1,
        "field_backward_v6": 2, "field_backward_v4_wgrad": 3}
    for a, b in zip(runs[0][1], runs[1][1]):  # no float atomics
        assert torch.equal(a, b)


def test_train_misaligned_operand_raises(field):
    mc, dirs = _inputs(2, 32)
    g = ff.mid_g_bands(field, dirs)
    packed = list(tft.pack_params_v4f(ff.pack_params_v3f(field), field))
    shifted = torch.empty(packed[20].numel() + 1, dtype=torch.float32,
                          device="cuda")[1:].view_as(packed[20])
    shifted.copy_(packed[20])
    packed[20] = shifted
    with pytest.raises(ValueError, match="aligned"):
        tft.field_forward_v6(packed, mc, g, 32, True)


def test_small_render_cpu_matches_gpu(field):
    mcfg = ModelConfig(num_coarse_samples=16, num_importance_samples=16,
                       num_reflect_coarse_samples=16,
                       num_reflect_importance_samples=16,
                       compute_dtype="bfloat16")
    config = TrainerConfig(pipeline=PipelineConfig(model=mcfg))
    cams = make_synthetic_cameras(num_cameras=2, H=12, W=12)
    field_cpu = Field()
    field_cpu.load_state_dict({k: v.cpu() for k, v in
                               field.state_dict().items()})
    outs = [render_image(f, cams.to(dev), 1, config, product_only=po)
            for po in (True, False)
            for f, dev in ((field_cpu, "cpu"), (field, "cuda"))]
    for cpu, gpu in (outs[0:2], outs[2:4]):
        agree = cpu["mask"] == gpu["mask"]
        assert agree.mean() >= 0.99
        for k in set(cpu) - {"mask"}:
            diff = np.abs(cpu[k] - gpu[k])[agree[..., 0]]
            if k.startswith("depth"):
                # a median depth is a bin midpoint: bf16 noise can move it
                # by a whole bin on a few rays
                assert np.mean(diff <= 0.05) >= 0.9, k
            else:
                assert diff.max() <= 0.05, k


@pytest.fixture(scope="module")
def proposal(field):
    return ProposalField(torch.Generator().manual_seed(5)).cuda().eval()


# K9's row counts: one row, 15 / 63 / 65 / 1,000 / 131,089 (ragged 16-row
# warp tiles), 64, and (1000, 64) for many tiles per warp of the
# persistent grid
PROP_SHAPES = [(1, 1), (3, 29), (5, 64), (3, 7), (1000, 64), (15, 1),
               (7, 9), (1, 64), (5, 13), (8, 125), (131089, 1)]


def _prop_rows(R: int, S: int):
    """_inputs' rows with, from 24 rows on, a NaN mean, an infinite mean
    (sin(inf) is NaN) and an infinite variance (damped to zero: finite)
    in three rows."""
    mc, _ = _inputs(R, S, seed=S)
    if mc.shape[0] >= 24:
        mc[5, 1] = float("nan")
        mc[13, 0] = float("inf")
        mc[21, 4] = float("inf")
    return mc


@pytest.fixture(scope="module")
def k9_first_design(proposal):
    from rsn_torch.kernels.build import start_variant

    lib, _ = start_variant("proposal_forward.cu", ("RSN_K9_FIRST_DESIGN",),
                           "first_design")()
    return lib


@pytest.mark.parametrize("R,S", PROP_SHAPES)
def test_prop_kernel_matches_plain_version(proposal, R, S):
    """K9 against its plain version: ragged last tiles, one row, and
    (1000, 64) for more tiles than warps; within 1e-2 of max |preact|
    (bf16 activations, fp32 sums in another order) on the finite rows,
    NaN where the plain version has NaN (the ReLU keeps it)."""
    mc = _prop_rows(R, S)
    packed = pf.pack_prop_params(proposal)
    got = pf.prop_forward(packed, mc)
    torch.cuda.synchronize()
    ref = pf.prop_forward_plain(packed, mc)
    assert got.shape == (R * S,) and got.dtype == torch.float32
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert int(nan.sum()) == (2 if R * S >= 24 else 0)
    assert torch.isfinite(got[~nan]).all()
    scale = float(ref[~nan].abs().max())
    assert float((got - ref)[~nan].abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("R,S", PROP_SHAPES)
def test_prop_kernel_equals_its_first_design(proposal, k9_first_design, R,
                                             S):
    """The register-resident K9 against the RSN_K9_FIRST_DESIGN build of
    the same source, bit for bit (NaN rows included)."""
    mc = _prop_rows(R, S)
    packed = pf.pack_prop_params(proposal)
    ff.reset_launch_counts()
    got = pf.prop_forward(packed, mc)
    old = pf.launch_prop(k9_first_design, packed, mc)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), old.view(torch.int32))
    assert ff.LAUNCHES["prop_forward"] == 1


def test_prop_launch_counts_and_determinism(proposal):
    mc, _ = _inputs(6, 64)
    packed = pf.pack_prop_params(proposal)
    ff.reset_launch_counts()
    a = pf.prop_forward(packed, mc)
    b = pf.prop_forward(packed, mc)
    pf.prop_forward_plain(packed, mc)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["prop_forward"] == 2
    assert sum(ff.LAUNCHES.values()) == 2
    assert torch.equal(a, b)  # a fixed summation order, no atomics


def test_prop_misaligned_operand_raises(proposal):
    mc, _ = _inputs(2, 32)
    packed = list(pf.pack_prop_params(proposal))
    shifted = torch.empty(packed[0].numel() + 1, dtype=torch.bfloat16,
                          device="cuda")[1:].view_as(packed[0])
    shifted.copy_(packed[0])
    packed[0] = shifted
    with pytest.raises(ValueError, match="aligned"):
        pf.prop_forward(packed, mc)


def test_small_preset_render_cpu_matches_gpu(field, proposal):
    mcfg = ModelConfig(num_proposal_samples=16, num_importance_samples=16,
                       num_reflect_coarse_samples=16,
                       num_reflect_importance_samples=16,
                       use_proposal=True, use_proposal_reflect=True,
                       use_pallas_proposal=True, compute_dtype="bfloat16")
    config = TrainerConfig(pipeline=PipelineConfig(model=mcfg))
    cams = make_synthetic_cameras(num_cameras=2, H=12, W=12)
    field_cpu, prop_cpu = Field(), ProposalField()
    field_cpu.load_state_dict({k: v.cpu() for k, v in
                               field.state_dict().items()})
    prop_cpu.load_state_dict({k: v.cpu() for k, v in
                              proposal.state_dict().items()})
    ff.reset_launch_counts()
    cpu, gpu = (render_image(f, cams.to(dev), 1, config, product_only=True,
                             proposal=p)
                for f, p, dev in ((field_cpu, prop_cpu, "cpu"),
                                  (field, proposal, "cuda")))
    assert ff.LAUNCHES["prop_forward"] == ff.LAUNCHES["field_forward_v3"] == 2
    agree = cpu["mask"] == gpu["mask"]
    assert agree.mean() >= 0.99
    diff = np.abs(cpu["mid_reflect_fine"] - gpu["mid_reflect_fine"])
    assert diff[agree[..., 0]].max() <= 0.05


# ---- the recompute route (K7, K1 at the train width, K8) ------------------

K8_TOL = 1e-1  # plain K8 recomputes its own trunk: bf16 rounding flips


def _same(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def _k8_matches_k4(k8, k4):
    """K8 equals K4 on K3's spill on dmc, dg and the 20 gradients, bit for
    bit: one schedule, the same operands, the same sums."""
    flat = lambda res: [res[0], res[1], *res[2]]
    for i, (got, ref) in enumerate(zip(flat(k8), flat(k4))):
        assert got.shape == ref.shape, i
        assert torch.equal(got, ref), i


# (301, 100) and (1030, 128) take K8 over several chunks on 132 SMs: a
# short last chunk, tile0 > 0, and a last block whose run ends chunks early
# (its records zeroed)
@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (5, 29), (7, 64),
                                 (33, 128), (301, 100), (1030, 128)])
def test_recompute_kernels_match_plain_versions(field, R, S):
    """K7 and K1 at the train width equal K3's output bit for bit and
    agree with their plain versions; K8 equals K4 on K3's spill bit for
    bit (dmc, dg, all 20 gradients), agrees with the plain K4 on that
    spill within ATOL and with its own plain version (which recomputes the
    trunk) within K8_TOL, and gives the same bits twice."""
    mc, dirs = _inputs(R, S, seed=R + S)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3f(field)
    p4 = tft.pack_params_v4f(p3, field)
    k7 = tft.field_forward_v4(p4, mc, g, S)
    k1 = tft.field_forward_v3_train(p3, mc, g, S)
    k3n, acts = tft.field_forward_v6(p4, mc, g, S, True)
    k3, _ = tft.field_forward_v6(p3, mc, g, S)
    torch.cuda.synchronize()
    assert torch.equal(k7, k3n) and torch.equal(k1, k3)
    cols = list(range(14)) + list(range(17, 20))
    for got, normals in ((k7, True), (k1, False)):
        ref = tft.field_forward_v4_plain(p4 if normals else p3, mc, g, S,
                                         normals)
        assert torch.isfinite(got.float()).all()
        assert float((got[:, cols].float() - ref[:, cols].float()).abs()
                     .max()) <= ATOL
    chain = tft.normals_dgrad_plain(p4, tft._split_acts(acts), mc)
    unit = lambda v: -torch.nn.functional.normalize(v.float(), dim=-1)
    live = chain.norm(dim=-1) > 1e-3
    assert float((unit(k7[:, 14:17]) * unit(chain)).sum(-1)[live].min()) \
        >= 0.999
    assert torch.all(k1[:, 14:17] == 0)

    gen = torch.Generator().manual_seed(S)
    d_out = torch.randn(R * S, tft.OUT_TRAIN, generator=gen)
    d_out[:, 14:] = 0.0
    d_out = d_out.to(torch.bfloat16).cuda()
    k8 = tft.field_backward_v4(p3, mc, g, d_out, k7, S)
    k8b = tft.field_backward_v4(p3, mc, g, d_out, k7, S)
    k4 = tft.field_backward_v5(p3, mc, g, acts, d_out, k7, S)
    torch.cuda.synchronize()
    assert _same(k8, k8b)
    _k8_matches_k4(k8, k4)
    for ref, tol in ((tft.field_backward_v5_plain(p3, mc, g, acts, d_out,
                                                  k7, S), ATOL),
                     (tft.field_backward_v4_plain(p3, mc, g, d_out, k7, S),
                      K8_TOL)):
        assert _rel_err(k8[0], ref[0]) <= tol
        assert _rel_err(k8[1], ref[1]) <= tol
        for a, b in zip(k8[2], ref[2]):
            assert a.shape == b.shape and _rel_err(a, b) <= tol


def _tiny_trainer(tmp_path, camera: bool, acts: bool):
    from rsn_torch.configs import DataManagerConfig
    from rsn_torch.engine.trainer import Trainer

    mcfg = ModelConfig(compute_dtype="bfloat16", use_pallas_acts=acts)
    dm = DataManagerConfig(dataparser="synthetic", data="sphere:res=16",
                           camera_optimizer="SO3xR3" if camera else "off")
    config = TrainerConfig(pipeline=PipelineConfig(model=mcfg,
                                                   datamanager=dm))
    return Trainer(config, run_dir=str(tmp_path / f"{camera}-{acts}"),
                   device="cuda")


@pytest.mark.parametrize("camera,acts,want", [
    (False, True, {"field_forward_v6": 4, "field_backward_v5": 2,
                   "field_backward_v6": 2}),
    (False, False, {"field_forward_v4": 2, "field_forward_v3_train": 2,
                    "field_backward_v4": 4}),
    (True, True, {"field_forward_v6": 4, "field_backward_v5": 8}),
    (True, False, {"field_forward_v4": 2, "field_forward_v3_train": 2,
                   "field_backward_v4": 8}),
])
def test_train_step_launches_per_route(field, tmp_path, monkeypatch, camera,
                                       acts, want):
    """The launches of one default-method train step on each route, with
    the camera optimizer off and on (two backward passes): `want` gives
    the forwards' launches and the backward calls; kernel A of K4, K5 and
    K8 launches once per chunk of each call's stash_plan, kernel B once
    per chunk of all three, and the forwards' weight blob is packed once
    a step."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = {k: [] for k in tft.STASH_KERNELS}

    def recording(name):
        real = getattr(tft, name)

        def fn(*args):
            g = args[1] if name == "field_backward_v6" else args[2]
            chunks[name].append(len(tft.stash_plan(g.shape[0], args[-1],
                                                   sms).chunks))
            return real(*args)
        return fn

    for name in tft.STASH_KERNELS:
        monkeypatch.setattr(tft, name, recording(name))
    tr = _tiny_trainer(tmp_path, camera, acts)
    ff.reset_launch_counts()
    tr.train_step()
    torch.cuda.synchronize()
    got = {k: v for k, v in ff.LAUNCHES.items() if v}
    want = dict(want)
    for name in tft.STASH_KERNELS:
        assert len(chunks[name]) == want.pop(name, 0), name
        if chunks[name]:
            want[name] = sum(chunks[name])
    want["field_backward_v4_wgrad"] = sum(map(sum, chunks.values()))
    want["train_blob"] = 1
    assert got == want
    if camera:
        assert torch.isfinite(tr.camera).all() and tr.camera.abs().max() > 0


# (301, 100) and (1030, 128) take the spill route's backward over several
# chunks on 132 SMs: a short last chunk, tile0 > 0, and a last block whose
# run ends chunks early (its records zeroed)
@pytest.mark.parametrize("R,S", [(1, 1), (5, 29), (33, 128), (301, 100),
                                 (1030, 128)])
def test_spill_backward_identities(field, R, S):
    """K4 and K5 on K3's spill (K4 on the activations, K5 on them with x):
    K4 equals K8 on dmc, dg and the 20 gradients, and K5 equals K4 on dg
    and the 20 gradients, bit for bit (one schedule, the same operands);
    each within ATOL of its plain version; K5 the same bits twice."""
    mc, dirs = _inputs(R, S, seed=R * S)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3f(field)
    out, xacts = tft.field_forward_v6(p3, mc, g, S, False, True)
    acts = xacts[:, :tft.ACTS_COLS].contiguous()
    gen = torch.Generator().manual_seed(R + S)
    d_out = torch.randn(R * S, tft.OUT_TRAIN, generator=gen)
    d_out[:, 14:] = 0.0
    d_out = d_out.to(torch.bfloat16).cuda()
    k8 = tft.field_backward_v4(p3, mc, g, d_out, out, S)
    k4 = tft.field_backward_v5(p3, mc, g, acts, d_out, out, S)
    k5 = tft.field_backward_v6(p3, g, xacts, d_out, out, S)
    k5b = tft.field_backward_v6(p3, g, xacts, d_out, out, S)
    torch.cuda.synchronize()
    _k8_matches_k4(k8, k4)
    assert torch.equal(k5[0], k5b[0])
    assert all(torch.equal(a, b) for a, b in zip(k5[1], k5b[1]))
    assert torch.equal(k5[0], k4[1])
    assert all(torch.equal(a, b) for a, b in zip(k5[1], k4[2]))
    ref4 = tft.field_backward_v5_plain(p3, mc, g, acts, d_out, out, S)
    ref5 = tft.field_backward_v6_plain(p3, g, xacts, d_out, out, S)
    assert _rel_err(k4[0], ref4[0]) <= ATOL
    for got, ref in ((k4[1:], ref4[1:]), (k5, ref5)):
        assert _rel_err(got[0], ref[0]) <= ATOL
        for a, b in zip(got[1], ref[1]):
            assert a.shape == b.shape and _rel_err(a, b) <= ATOL


def test_recompute_route_holds_less_memory(field, tmp_path):
    """One full-width step's peak device memory above what the trainer
    holds before it: the recompute route keeps no (N, 2048) spill."""
    peaks = {}
    for acts in (True, False):
        tr = _tiny_trainer(tmp_path, True, acts)
        tr.train_step()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step()
        torch.cuda.synchronize()
        peaks[acts] = torch.cuda.max_memory_allocated() - base
        del tr
        torch.cuda.empty_cache()
    assert peaks[False] < peaks[True], peaks


# ---- the field API (K11, K12) and the schedule variants (K10, K13) -------

K13_TOL = 1e-4  # K13's weight gradients against K8's: another fp32 order


@pytest.mark.parametrize("records,slices", [(512, 7), (37, 7), (3, 2)])
def test_wgrad_kernel_matches_plain_contraction(field, records, slices):
    """Kernel B alone on a seeded workspace (a full chunk of the camera-on
    step's 128 blocks x 4 tiles, a ragged one, fewer records than slices
    would want): each tile's sum over the P partials within K13_TOL of
    each weight's max of the plain fp32 contraction, overwriting and then
    adding to the partials; the same bits twice."""
    gen = torch.Generator().manual_seed(records)
    ws = torch.randn(records, wg.REC_ELEMS, generator=gen).to(
        torch.bfloat16).cuda()
    ref = torch.zeros(slices, wg.PARTIAL_FLOATS, device="cuda")
    wg.contract_plain(ws, ref, accumulate=False)
    got = torch.full_like(ref, float("nan"))
    again = torch.empty_like(ref)
    ff.reset_launch_counts()
    wg.contract(ws, got, accumulate=False)
    wg.contract(ws, again, accumulate=False)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["field_backward_v4_wgrad"] == 2
    assert torch.equal(got, again)
    for w, r in zip(wg.weight_grads(got), wg.weight_grads(ref)):
        assert _rel_err(w, r) <= K13_TOL
    wg.contract(ws, got, accumulate=True)
    wg.contract_plain(ws, ref, accumulate=True)
    torch.cuda.synchronize()
    for w, r in zip(wg.weight_grads(got), wg.weight_grads(ref)):
        assert _rel_err(w, r) <= K13_TOL


@pytest.mark.parametrize("n", [1, 77, 1000, 4099])
def test_field_api_kernels_match_plain_versions(field, n):
    """K11 and K12 against their plain versions on ragged row counts:
    every live OUT_* column within ATOL, the padding zero; K12 on the
    plain encoding of the rows; both density columns against K2's within
    ATOL (K2's IPE is the polynomial one)."""
    mc, _ = _inputs(n, 1, seed=n)
    packed = ff.pack_params(field)
    enc = ff.ipe_enc(mc)
    k11 = ff.field_forward_v2(packed, mc)
    k12 = ff.field_forward(packed, enc)
    k2 = ff.field_forward_density(ff.pack_params_density(field), mc)
    torch.cuda.synchronize()
    live = ff.N_HEAD_COLS
    for got, ref in ((k11, ff.field_forward_v2_plain(packed, mc)),
                     (k12, ff.field_forward_plain(packed, enc))):
        assert got.shape == (n, ff.OUT_DIM) and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        assert float((got[:, :live].float() - ref[:, :live].float()).abs()
                     .max()) <= ATOL
        assert torch.all(got[:, live:] == 0)
        assert float((got[:, ff.OUT_DENSITY].float() - k2[:, 0].float())
                     .abs().max()) <= ATOL


@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (5, 29), (300, 64),
                                 (1000, 64)])
def test_k10_equals_k7_and_k1_train_width(field, R, S):
    """K10 with the normals equals K7, without them K1 at the train width,
    bit for bit (one tile, ragged tiles, and more tiles than blocks: both
    slots of every block), and agrees with the plain version."""
    mc, dirs = _inputs(R, S, seed=R * S)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3f(field)
    p4 = tft.pack_params_v4f(p3, field)
    k10n = tft.field_forward_v5(p4, mc, g, S, True)
    k10 = tft.field_forward_v5(p3, mc, g, S, False)
    k7 = tft.field_forward_v4(p4, mc, g, S)
    k1 = tft.field_forward_v3_train(p3, mc, g, S)
    torch.cuda.synchronize()
    assert torch.equal(k10n, k7) and torch.equal(k10, k1)
    cols = list(range(14)) + list(range(17, 20))
    for got, pk, normals in ((k10n, p4, True), (k10, p3, False)):
        ref = tft.field_forward_v4_plain(pk, mc, g, S, normals)
        assert float((got[:, cols].float() - ref[:, cols].float()).abs()
                     .max()) <= ATOL


def test_train_blob_packs_on_the_card(field):
    """One launch packs the forwards' train blob from the fp32 operands
    (transposed views among them) or from the bf16 ones, equal to the
    plain trunk_sm90.pack_train_blob bit for bit; each counts one
    train_blob launch."""
    p32 = ff.pack_params_v3f_f32(field)
    p3 = ff.pack_params_v3f(field)
    ff.reset_launch_counts()
    a = tft.train_blob(p32[:8], p32[16])
    b = tft.train_blob(p3[:8], p3[16])
    torch.cuda.synchronize()
    ref = ts.pack_train_blob([w.cpu() for w in p3[:8]], p3[16].cpu())
    assert torch.equal(a.cpu(), ref) and torch.equal(b.cpu(), ref)
    assert ff.LAUNCHES["train_blob"] == 2


# 64 x 128 rows: 64 tiles of 128 rows; (301, 100) and (1030, 128): a
# ragged last tile and more tiles than 132 blocks
@pytest.mark.parametrize("R,S", [(64, 128), (301, 100), (1030, 128)])
@pytest.mark.parametrize("normals,spill_x", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_train_forwards_on_the_ring(field, R, S, normals, spill_x):
    """K3, and K7 (normals) or K1 at the train width, on trunk_sm90.cuh's
    ring: within ATOL of the plain version (of each tensor's max; the
    normals against the plain dgrad on K3's own activations); K3 == K7 /
    K1 at the train width == K10 (the 64-row wmma forward, whose sums run
    in the same order) bit for bit; the spill within one bf16 ulp of the
    plain one on 99.9% of entries, its activations the same bits with and
    without x, x's padding zero; K8 == K4 on it (dmc, dg, all 20
    gradients)."""
    mc, dirs = _inputs(R, S, seed=R + S)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3f(field)
    pk = tft.pack_params_v4f(p3, field) if normals else p3
    blob = tft.train_blob(p3[:8], p3[16])
    k3, acts = tft.field_forward_v6(pk, mc, g, S, normals, spill_x,
                                    blob=blob)
    _, bare = tft.field_forward_v6(pk, mc, g, S, normals, False, blob=blob)
    fwd = tft.field_forward_v4 if normals else tft.field_forward_v3_train
    k7 = fwd(pk, mc, g, S, blob=blob)
    k10 = tft.field_forward_v5(pk, mc, g, S, normals)
    torch.cuda.synchronize()
    assert torch.equal(k3, k7) and torch.equal(k10, k7)
    ref, ref_acts = tft.field_forward_v6_plain(pk, mc, g, S, normals,
                                               spill_x)
    cols = list(range(14)) + list(range(17, 20))
    assert torch.isfinite(k3.float()).all()
    assert _rel_err(k3[:, cols], ref[:, cols]) <= ATOL
    assert torch.all(k3[:, 20:] == 0)
    if normals:
        chain = tft.normals_dgrad_plain(pk, tft._split_acts(acts), mc)
        assert _rel_err(k3[:, 14:17], chain) <= ATOL
    else:
        assert torch.all(k3[:, 14:17] == 0)
    assert acts.shape == ref_acts.shape
    assert _bf16_ulp_share(acts, ref_acts) >= 0.999
    assert torch.equal(acts[:, :tft.ACTS_COLS], bare)
    if spill_x:
        assert torch.all(acts[:, tft.ACTS_COLS + 99:] == 0)

    gen = torch.Generator().manual_seed(R)
    d_out = torch.randn(R * S, tft.OUT_TRAIN, generator=gen)
    d_out[:, 14:] = 0.0
    d_out = d_out.to(torch.bfloat16).cuda()
    k8 = tft.field_backward_v4(p3, mc, g, d_out, k3, S)
    k4 = tft.field_backward_v5(p3, mc, g, bare, d_out, k3, S)
    torch.cuda.synchronize()
    _k8_matches_k4(k8, k4)


@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (5, 29), (33, 128),
                                 (1000, 64)])
def test_k13_deterministic_and_matches_k8(field, R, S):
    """K13 gives the same bits twice; its dmc and dg equal K8's; each of
    its 20 weight gradients is within K13_TOL of that tensor's max of
    K8's; and it agrees with its plain version as K8 does."""
    mc, dirs = _inputs(R, S, seed=R + 2 * S)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3f(field)
    out = tft.field_forward_v4(tft.pack_params_v4f(p3, field), mc, g, S)
    gen = torch.Generator().manual_seed(R)
    d_out = torch.randn(R * S, tft.OUT_TRAIN, generator=gen)
    d_out[:, 14:] = 0.0
    d_out = d_out.to(torch.bfloat16).cuda()
    a = tft.field_backward_v3(p3, mc, g, d_out, out, S)
    b = tft.field_backward_v3(p3, mc, g, d_out, out, S)
    k8 = tft.field_backward_v4(p3, mc, g, d_out, out, S)
    torch.cuda.synchronize()
    assert _same(a, b)
    assert torch.equal(a[0], k8[0]) and torch.equal(a[1], k8[1])
    assert len(a[2]) == 20
    for x, y in zip(a[2], k8[2]):
        assert x.shape == y.shape and _rel_err(x, y) <= K13_TOL
    ref = tft.field_backward_v4_plain(p3, mc, g, d_out, out, S)
    assert _rel_err(a[0], ref[0]) <= K8_TOL
    assert _rel_err(a[1], ref[1]) <= K8_TOL
    for x, y in zip(a[2], ref[2]):
        assert _rel_err(x, y) <= K8_TOL


def test_field_api_launch_counts_and_route(field):
    """Each wrapper counts its launches and nothing else (plain versions
    count none); the field's kernel route runs K11 and returns its heads."""
    mc, dirs = _inputs(4, 16)
    g = ff.mid_g_bands(field, dirs)
    packed, p3 = ff.pack_params(field), ff.pack_params_v3f(field)
    out = tft.field_forward_v3_train(p3, mc, g, 16)
    ff.reset_launch_counts()
    route = field.get_field_outputs(mc[:, 0:3].reshape(4, 16, 3),
                                    mc[:, 3:6].reshape(4, 16, 3),
                                    use_pallas=True, differentiable=False)
    k11 = ff.field_forward_v2(packed, mc)
    ff.field_forward(packed, ff.ipe_enc(mc))
    tft.field_forward_v5(p3, mc, g, 16)
    tft.field_backward_v3(p3, mc, g, out, out, 16)
    ff.field_forward_v2_plain(packed, mc)
    tft.field_backward_v4_plain(p3, mc, g, out, out, 16)
    torch.cuda.synchronize()
    # K13: K8's kernel A and kernel B once per chunk (one here), its sum
    assert {k: v for k, v in ff.LAUNCHES.items() if v} == {
        "field_forward_v2": 2, "field_forward": 1, "field_forward_v5": 1,
        "field_backward_v3": 1, "field_backward_v3_wgrad": 1,
        "field_backward_v3_sum": 1}
    assert route["bottleneck"].shape == (4, 16, 256)
    assert torch.equal(route["bottleneck"].reshape(64, 256),
                       k11[:, ff.OUT_BOTTLENECK])
    unit = route["pred_normals"].norm(dim=-1)
    assert float((unit - 1.0).abs().max()) <= 1e-5


@pytest.fixture(scope="module")
def k11_first_design(field):
    from rsn_torch.kernels.build import start_variant

    lib, _ = start_variant("field_forward.cu", ("RSN_K11_FIRST_DESIGN",),
                           "first_design")()
    return lib


# one row, a tile less one row, one tile, one tile and one row, 16,383
# rows, and 1,100 tiles (more than one per SM)
@pytest.mark.parametrize("n", [1, 127, 128, 129, 16383, 1100 * 128])
def test_field_api_kernels_equal_their_first_design(field, k11_first_design,
                                                    n):
    """K11's and K12's Hopper kernels (heads_sm90.cuh) against the
    RSN_K11_FIRST_DESIGN build of the same source, bit for bit: K12 on the
    rows' encoding and on one with a finite non-zero tail in its columns
    99..127 (K12 multiplies all 8 k-steps of its x part); the padding
    columns zero; one launch counted a call."""
    mc, _ = _inputs(n, 1, seed=n)
    packed = ff.pack_params(field)
    enc = ff.ipe_enc(mc)
    tail = enc.clone()
    gen = torch.Generator().manual_seed(n)
    tail[:, ff.IPE_OUT_DIM:] = (torch.randn(
        n, ff.ENC_PAD - ff.IPE_OUT_DIM, generator=gen) * 3).to(
            torch.bfloat16).cuda()
    assert torch.isfinite(tail.float()).all() and torch.any(
        tail[:, ff.IPE_OUT_DIM:] != 0)
    for name, fn, x in (("field_forward_v2", ff.field_forward_v2, mc),
                        ("field_forward", ff.field_forward, enc),
                        ("field_forward", ff.field_forward, tail)):
        ff.reset_launch_counts()
        got = fn(packed, x)
        old = ff.launch_heads(k11_first_design, name, packed, x)
        torch.cuda.synchronize()
        assert {k: v for k, v in ff.LAUNCHES.items() if v} == {name: 1}
        assert torch.equal(got, old), name
        assert torch.all(got[:, ff.N_HEAD_COLS:] == 0)


# ---- the tools' experiments: K14 (v3u, v3i), K15 (v3L, v3F), K16 ----------

@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (1, 16), (9, 16), (5, 29),
                                 (33, 128), (130, 64)])
def test_experiment_forwards_match_plain_versions(field, R, S):
    mc, dirs = _inputs(R, S, seed=7)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3(field)
    u = interleave.field_forward_v3u(p3, mc, g, S)
    i = interleave.field_forward_v3i(p3, mc, g, S)
    L = interleave2.field_forward_v3L(p3, mc, g, S)
    F = interleave2.field_forward_v3L(p3, mc, g, S, full=True)
    torch.cuda.synchronize()
    assert u.shape == (R * S, 128) and u.dtype == torch.bfloat16
    assert torch.equal(u, i) and torch.equal(L, F)
    for got, ref in ((u, interleave.field_forward_v3u_plain(p3, mc, g, S)),
                     (L, interleave2.field_forward_v3L_plain(p3, mc, g, S))):
        assert torch.isfinite(got.float()).all()
        assert torch.all(got[:, 14:] == 0)
        assert float((got.float() - ref.float()).abs().max()) <= ATOL
    k1 = ff.field_forward_v3(ff.pack_params_v3f(field), mc, g, S)
    assert float((L[:, :14].float() - k1[:, :14].float()).abs().max()) <= ATOL


@pytest.fixture(scope="module")
def k14_first_design(field):
    from rsn_torch.kernels.build import start_variant

    lib, _ = start_variant("experiments.cu", ("RSN_K14_FIRST_DESIGN",),
                           "first_design")()
    return lib


# fewer rows than one 128-row tile, S = 16, ragged last tiles, and (1100,
# 128): 1,100 tiles, more than one per SM
@pytest.mark.parametrize("R,S", [(1, 1), (1, 16), (9, 16), (3, 7), (5, 29),
                                 (130, 64), (1100, 128)])
def test_experiment_forwards_equal_their_first_design(field, k14_first_design,
                                                      R, S):
    """K14's and K15's Hopper kernels (unfolded_sm90.cuh) against the
    RSN_K14_FIRST_DESIGN build of the same source, bit for bit, each
    variant one launch counted."""
    mc, dirs = _inputs(R, S, seed=R + S)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3(field)
    for name, fn, flags in (
            ("field_forward_v3u", interleave.field_forward_v3u, ()),
            ("field_forward_v3i", interleave.field_forward_v3i, ()),
            ("field_forward_v3L", interleave2.field_forward_v3L, (False,)),
            ("field_forward_v3F", interleave2.field_forward_v3L, (True,))):
        ff.reset_launch_counts()
        got = fn(p3, mc, g, S, *flags)
        entry, lib_flags = interleave.ENTRIES[name]
        old = interleave.launch_kernel(k14_first_design, entry, p3, mc, g, S,
                                       *lib_flags)
        torch.cuda.synchronize()
        assert torch.equal(got, old), name
        assert {k: v for k, v in ff.LAUNCHES.items() if v} == {name: 1}


def test_experiment_launch_counts(field):
    mc, dirs = _inputs(4, 16)
    g = ff.mid_g_bands(field, dirs)
    p3 = ff.pack_params_v3(field)
    ff.reset_launch_counts()
    interleave.field_forward_v3u(p3, mc, g, 16)
    interleave.field_forward_v3i(p3, mc, g, 16)
    interleave2.field_forward_v3L(p3, mc, g, 16)
    interleave2.field_forward_v3L(p3, mc, g, 16, full=True)
    interleave2.field_forward_v3L(p3, mc, g, 16, full=True)
    interleave.field_forward_v3u_plain(p3, mc, g, 16)
    x = cheap_sin.tool_input(64, "cuda")
    cheap_sin.run("poly", x)
    cheap_sin.run_plain("poly", x)
    torch.cuda.synchronize()
    assert {k: v for k, v in ff.LAUNCHES.items() if v} == {
        "field_forward_v3u": 1, "field_forward_v3i": 1,
        "field_forward_v3L": 1, "field_forward_v3F": 2,
        "cheap_sin_poly": 1}


@pytest.mark.parametrize("mode", cheap_sin.MODES)
@pytest.mark.parametrize("n", [1, 77, 4099, 33333])
def test_cheap_sin_matches_plain_version(field, mode, n):
    x = cheap_sin.tool_input(n, "cuda", seed=n)
    got = cheap_sin.run(mode, x)
    ref = cheap_sin.run_plain(mode, x)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.float32
    if mode == "copy":
        assert torch.equal(got, ref)
    elif mode == "poly_bf16":
        assert torch.all((got - ref).abs() <= cheap_sin.bf16_ulp(ref))
    else:
        assert float((got - ref).abs().max()) <= 1e-6


# ---- the tools' backward experiments: K17, K18 (four modes), K19 ----------

def _bwd_inputs(field, R, S, seed):
    mc, dirs = _inputs(R, S, seed=seed)
    g = ff.mid_g_bands(field, dirs)
    gen = torch.Generator().manual_seed(seed)
    d_out = torch.randn(R * S, bwd_ablate.D_OUT_COLS, generator=gen)
    d_out[:, 14:] = 0.0
    return mc, g, d_out.to(torch.bfloat16).cuda()


@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (5, 29), (33, 128),
                                 (300, 64)])
def test_k17_matches_k8_and_plain(field, R, S):
    """K17 (128-row tiles): dmc and the weight matrices w0..w7, w_hc equal
    K8's bit for bit (kernel B sums K8's records), dg and each other
    gradient within K13_TOL of K8's (kernel A's sums over 128 rows change
    order); the same bits twice; against its plain version fed the
    kernel's activations (the plain K4 on K3's spill, = the recompute)
    within ATOL.  (The plain version that recomputes its own trunk is held
    at K8_TOL in chip_smoke.py at full size: on a few rows one bf16 flip
    of an activation moves a whole weight gradient, 1.3e-1 of its max at
    R=3, S=7 for K8 and K17 alike.)"""
    mc, g, d_out = _bwd_inputs(field, R, S, R + 3 * S)
    p3 = ff.pack_params_v3f(field)
    out = tft.field_forward_v3_train(p3, mc, g, S)
    _, acts = tft.field_forward_v6(p3, mc, g, S)
    d24 = d_out[:, :tft.OUT_TRAIN].contiguous()
    a = bwd_whole.field_backward_whole(p3, mc, g, d24, out, S)
    b = bwd_whole.field_backward_whole(p3, mc, g, d24, out, S)
    k8 = tft.field_backward_v4(p3, mc, g, d24, out, S)
    torch.cuda.synchronize()
    assert _same(a, b)
    assert torch.equal(a[0], k8[0])
    assert _rel_err(a[1], k8[1]) <= K13_TOL
    for x, y in zip(a[2], k8[2]):
        assert x.shape == y.shape and _rel_err(x, y) <= K13_TOL
    for i in list(range(8)) + [16]:
        assert torch.equal(a[2][i], k8[2][i]), i
    ref = tft.field_backward_v5_plain(p3, mc, g, acts, d24, out, S)
    for x, y in zip(a[:2] + tuple(a[2]), ref[:2] + tuple(ref[2])):
        assert _rel_err(x, y) <= ATOL


@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (5, 29), (33, 128),
                                 (300, 64)])
def test_k18_k19_match_plain_versions(field, R, S):
    """K18 in each mode against its plain version on K3's spill of the
    same rows (= the kernel's recompute) within ATOL of each output's max
    (the whole plain version, which recomputes its trunk, is held at
    K8_TOL in chip_smoke.py at full size, as K8 is); K19 on that spill ==
    K18's full mode (dg and the 22 gradients) bit for bit, and within
    ATOL of its plain version."""
    mc, g, d_out = _bwd_inputs(field, R, S, 2 * R + S)
    p3 = ff.pack_params_v3(field)
    _, xacts = tft.field_forward_v6(ff.pack_params_v3f(field), mc, g, S,
                                    spill_x=True)
    hs, x = tft._split_acts(xacts), xacts[:, tft.ACTS_COLS:]
    got = {}
    for mode, wg in bwd_ablate.VARIANTS:
        got[mode, wg] = k = bwd_ablate.run(mode, wg, p3, mc, g, d_out, S)
        torch.cuda.synchronize()
        assert (k[2] is None) == (not wg)
        ref = bwd_ablate.backward_from_acts(p3, hs, x, g, d_out, S, mode,
                                            wg, mc)
        assert _rel_err(k[0], ref[0]) <= ATOL, (mode, wg)
        assert _rel_err(k[1], ref[1]) <= ATOL, (mode, wg)
        for a, b in zip(k[2] or (), ref[2] or ()):
            assert a.shape == b.shape and _rel_err(a, b) <= ATOL
    full = got["full", True]
    assert torch.equal(full[0], got["full", False][0])
    assert torch.equal(full[1], got["full", False][1])
    k19 = bwd_noipe.run_noipe(p3, xacts, g, d_out, S)
    again = bwd_noipe.run_noipe(p3, xacts, g, d_out, S)
    torch.cuda.synchronize()
    assert torch.equal(k19[0], full[1])
    assert all(torch.equal(a, b) for a, b in zip(k19[1], full[2]))
    assert torch.equal(k19[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(k19[1], again[1]))
    ref = bwd_noipe.run_noipe_plain(p3, xacts, g, d_out, S)
    assert _rel_err(k19[0], ref[0]) <= ATOL
    for a, b in zip(k19[1], ref[1]):
        assert _rel_err(a, b) <= ATOL


def test_backward_experiment_launch_counts(field):
    mc, g, d_out = _bwd_inputs(field, 4, 16, 1)
    p3, p1 = ff.pack_params_v3(field), ff.pack_params_v3f(field)
    out, xacts = tft.field_forward_v6(p1, mc, g, 16, spill_x=True)
    d24 = d_out[:, :tft.OUT_TRAIN].contiguous()
    ff.reset_launch_counts()
    bwd_whole.field_backward_whole(p1, mc, g, d24, out, 16)
    for mode, wg in bwd_ablate.VARIANTS:
        bwd_ablate.run(mode, wg, p3, mc, g, d_out, 16)
    bwd_ablate.run("recompute", False, p3, mc, g, d_out, 16)
    bwd_noipe.run_noipe(p3, xacts, g, d_out, 16)
    bwd_noipe.run_noipe_plain(p3, xacts, g, d_out, 16)
    bwd_ablate.bwd_ablate_plain(p3, mc, g, d_out, 16)
    torch.cuda.synchronize()
    assert {k: v for k, v in ff.LAUNCHES.items() if v} == {
        "field_backward_whole": 1, "field_backward_whole_wgrad": 1,
        "bwd_ablate_full_wgrad": 1,
        "bwd_ablate_full": 1, "bwd_ablate_no_ipe_bwd": 1,
        "bwd_ablate_recompute": 2, "run_noipe": 1, "bwd_unfolded_wgrad": 2}


@pytest.fixture(scope="module")
def k18_first_design(field):
    from rsn_torch.kernels.build import start_variant

    lib, _ = start_variant("experiments_bwd.cu", ("RSN_K18_FIRST_DESIGN",),
                           "first_design")()
    return lib


# one ray, a ragged last tile, and (300, 200): 3 rays a block, 10 tiles, 3
# chunks
@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (300, 200)])
def test_k18_k19_equal_their_first_design(field, k18_first_design, R, S):
    """K18 full + wgrad and K19 (kernel A + kernel B per chunk) against the
    RSN_K18_FIRST_DESIGN build of the same source: dmc and dg bit for bit,
    the 22 gradients within K13_TOL of each max (the same products summed
    in another order); K19 == K18 on K3's spill; one launch of kernel A
    and one of kernel B counted per chunk."""
    mc, g, d_out = _bwd_inputs(field, R, S, 7 * R + S)
    p3 = ff.pack_params_v3(field)
    _, xacts = tft.field_forward_v6(ff.pack_params_v3f(field), mc, g, S,
                                    spill_x=True)
    chunks = len(bwd_ablate.stash_plan(
        R, S, torch.cuda.get_device_properties(0).multi_processor_count)
        .chunks)
    assert chunks == (3 if R == 300 else 1)
    ff.reset_launch_counts()
    k18 = bwd_ablate.run("full", True, p3, mc, g, d_out, S)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["bwd_ablate_full_wgrad"] == chunks
    assert ff.LAUNCHES[wg.UNFOLDED.label] == chunks
    k19 = bwd_noipe.run_noipe(p3, xacts, g, d_out, S)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["run_noipe"] == chunks
    assert ff.LAUNCHES[wg.UNFOLDED.label] == 2 * chunks
    for got, label, inputs in (
            (k18, "bwd_ablate_full_wgrad", (p3, mc, g, d_out)),
            ((None,) + k19, "run_noipe", (p3, g, xacts, d_out))):
        old = bwd_ablate.first_design(k18_first_design, label, inputs, S)
        torch.cuda.synchronize()
        if got[0] is not None:
            assert torch.equal(got[0], old[0])
        assert torch.equal(got[1], old[1])
        assert len(got[2]) == 22
        for a, b in zip(got[2], old[2]):
            assert a.shape == b.shape and _rel_err(a, b) <= K13_TOL
    assert torch.equal(k19[0], k18[1])
    assert all(torch.equal(a, b) for a, b in zip(k19[1], k18[2]))


@pytest.fixture(scope="module")
def k13_first_design(field):
    from rsn_torch.kernels.build import start_variant

    lib, _ = start_variant("field_train.cu", ("RSN_K13_FIRST_DESIGN",),
                           "first_design")()
    return lib


# one ray, a ragged tile, (300, 140): 3 rays a block, 7 tiles (odd: K17's
# last 128-row tile has no second half) in 2 chunks, and (1030, 128): 16
# tiles in 4 chunks, the last block's run 4 tiles short
@pytest.mark.parametrize("R,S", [(1, 1), (3, 7), (300, 140), (1030, 128)])
def test_k13_k17_equal_their_first_design(field, k13_first_design, R, S):
    """K13 and K17 (kernel A and kernel B per chunk of K8's plan; K13 then
    its sum) against the RSN_K13_FIRST_DESIGN build of the same source:
    dmc bit for bit, K13's dg too, the other outputs within K13_TOL of each
    max (the same products summed in another order); K17's w0..w7 and
    w_hc == K8's bit for bit; each kernel counted once per chunk."""
    mc, g, d_out = _bwd_inputs(field, R, S, 5 * R + S)
    p3 = ff.pack_params_v3f(field)
    out = tft.field_forward_v3_train(p3, mc, g, S)
    d24 = d_out[:, :tft.OUT_TRAIN].contiguous()
    args = (p3, mc, g, d24, out, S)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = len(tft.stash_plan(R, S, sms).chunks)
    assert chunks == {300: 2, 1030: 4}.get(R, 1)
    ff.reset_launch_counts()
    k13 = tft.field_backward_v3(*args)
    k17 = bwd_whole.field_backward_whole(*args)
    torch.cuda.synchronize()
    assert {k: v for k, v in ff.LAUNCHES.items() if v} == {
        "field_backward_v3": chunks, "field_backward_v3_wgrad": chunks,
        "field_backward_v3_sum": 1, "field_backward_whole": chunks,
        "field_backward_whole_wgrad": chunks}
    old13 = tft.field_backward_v3_first_design(k13_first_design, *args)
    old17 = bwd_whole.first_design(k13_first_design, *args)
    k8 = tft.field_backward_v4(*args)
    torch.cuda.synchronize()
    assert torch.equal(k13[0], old13[0]) and torch.equal(k13[1], old13[1])
    assert torch.equal(k17[0], old17[0])
    assert _rel_err(k17[1], old17[1]) <= K13_TOL
    for got, old in ((k13, old13), (k17, old17)):
        assert len(got[2]) == 20
        for a, b in zip(got[2], old[2]):
            assert a.shape == b.shape and _rel_err(a, b) <= K13_TOL
    for i in list(range(8)) + [16]:
        assert torch.equal(k17[2][i], k8[2][i]), i


@pytest.mark.parametrize("blocks,slices", [(1, 1), (37, 3), (129, 7)])
def test_k13_sum_matches_its_plain_version(field, blocks, slices):
    """K13's sum launch on seeded slices and partials equals its plain
    version run on the same card tensors bit for bit (the same fp32 adds
    in the same order), and counts one launch."""
    gen = torch.Generator().manual_seed(blocks)
    small = torch.randn(blocks, tft.SMALL_FLOATS, generator=gen).cuda()
    partial = torch.randn(slices, wg.PARTIAL_FLOATS, generator=gen).cuda()
    ff.reset_launch_counts()
    got = tft.k13_sum(small, partial)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["field_backward_v3_sum"] == 1
    want = torch.cat([t.reshape(-1) for t in
                      tft.k13_sum_plain(small, partial)])
    assert torch.equal(got, want)
