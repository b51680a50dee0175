"""rsn_torch.parallel.mesh against rsn's pmean, on the CPU: two gloo ranks
(mesh.launch) all-reduce their gradients of one bundle each, against the
mean of rsn's per-bundle gradients, what rsn's shard_map step pmeans.
rsn's gradients compile while the ranks run.

The ranks import this module by name: its top level imports nothing of
rsn or jax."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rsn_torch import configs as tcfg
from rsn_torch.core.rays import RayBundle
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.models import model as tmodel
from rsn_torch.parallel import mesh as mesh_lib
from test_torch_parallel import _field, _render_config

R = 16


def _port_grads(field, rays, gt, mesh=None):
    """The port's fp32 step on one bundle with midpoint draws (step 100:
    every loss on), its gradients all-reduced over the mesh -> rsn's
    params layout."""
    o, d, pa = rays
    near, far = np.full((o.shape[0], 1), 2.0, np.float32), np.full(
        (o.shape[0], 1), 6.0, np.float32)
    tb = RayBundle(*(torch.from_numpy(np.array(v, np.float32))
                     for v in (o, d, pa, near, far)))
    cfg = _render_config().pipeline.model
    tb = tmodel.apply_collider(tb, cfg)
    field.zero_grad(set_to_none=True)
    out = tmodel.get_outputs(field, tb, cfg, training=True, rays_live=False)
    ld = tmodel.get_loss_dict(out, torch.from_numpy(gt),
                              tcfg.loss_coefficients_at_step(100))
    sum(ld.values()).backward()
    if mesh is not None:
        mesh_lib.average_gradients(mesh, list(field.parameters()))
    return tckpt.params_to_rsn({
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        for k, p in field.named_parameters()})


def _ranks(mesh, train_state, bundles):
    """Rank `mesh.rank`: its bundle's all-reduced gradients."""
    return _port_grads(_field(train_state), *bundles[mesh.rank], mesh=mesh)


@pytest.fixture(scope="module")
def scene():
    """test_train_step_fp32_matches_rsn's weights and rays, whose limits
    these are, and a target for each rank."""
    from torch_parity import facing_rays, rsn_params

    bundles = [(facing_rays(R), np.random.default_rng(5 + r).uniform(
        0, 1, (R, 3)).astype(np.float32)) for r in range(2)]
    return rsn_params(4, crafted_normals=True), bundles


@pytest.fixture(scope="module")
def ranks_running(scene):
    """The 2-rank launch, from a thread: rsn's gradients compile while the
    ranks run."""
    tree, bundles = scene
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(mesh_lib.launch, _ranks, 2, (
            tckpt.params_from_rsn(tree), bundles), device="cpu")


def _rsn_grads(tree, bundles):
    """rsn's loss gradients of each (rays, target) with the samplers'
    jitter off (as tests/test_torch_train.py's _rsn_step), one jit for
    all."""
    import jax
    import jax.numpy as jnp

    import rsn.configs as jcfg
    from rsn.models import model as M
    from torch_parity import bundles as both, jax_params

    cfg = jcfg.ModelConfig(num_coarse_samples=8, num_importance_samples=8,
                           num_reflect_coarse_samples=8,
                           num_reflect_importance_samples=8)
    spaced, pdf = M.spaced_sample, M.pdf_sample
    M.spaced_sample = lambda b, s, k, key=None, **kw: spaced(b, s, k, **kw)
    M.pdf_sample = lambda b, rs, w, s, k, key=None, **kw: pdf(b, rs, w, s,
                                                             k, **kw)
    try:
        def total(p, jb, gt):
            out = M.get_outputs(p, M.apply_collider(jb, cfg),
                                jax.random.PRNGKey(0), cfg, training=True,
                                rays_live=False)
            ld = M.get_loss_dict(out, gt,
                                 jcfg.loss_coefficients_at_step(100))
            return sum(jax.tree.leaves(ld))

        grad = jax.jit(jax.grad(total))
        grads = [grad(jax_params(tree), both(*rays)[0], jnp.asarray(gt))
                 for rays, gt in bundles]
    finally:
        M.spaced_sample, M.pdf_sample = spaced, pdf
    return [jax.tree.map(np.asarray, g) for g in grads]


def test_all_reduced_gradients_are_rsns_pmean(scene, ranks_running):
    """Each rank's fp32 step on its own bundle, all-reduced, against the
    mean of rsn's per-bundle gradients (what rsn's shard_map step pmeans),
    at test_train_step_fp32_matches_rsn's limits."""
    from torch_parity import assert_grads

    per = _rsn_grads(*scene)
    ranks = ranks_running.result()
    want = {k: (
        [{n: (a[n] + b[n]) / 2 for n in a} for a, b in zip(per[0][k],
                                                           per[1][k])]
        if isinstance(per[0][k], list)
        else {n: (per[0][k][n] + per[1][k][n]) / 2 for n in per[0][k]})
        for k in per[0]}
    for grads in ranks:
        assert_grads(grads, want, 1e-4, {("trunk", 0): 5e-3})
    # and they are not one bundle's alone
    with pytest.raises(AssertionError):
        assert_grads(ranks[0], per[0], 1e-4, {("trunk", 0): 5e-3})
