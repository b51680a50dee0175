"""Shared setup of the rsn_torch parity tests: one params tree and one
set of numpy inputs, fed to the JAX package and to the PyTorch port."""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rsn.core.rays import RayBundle as JRayBundle
from rsn.models import field as jfield
from rsn_torch.core.rays import RayBundle as TRayBundle
from rsn_torch.engine.checkpoints import params_from_rsn
from rsn_torch.models.field import Field


def rsn_params(seed: int = 0, crafted_normals: bool = False):
    """rsn's init_field_params as a numpy tree.  crafted_normals gives the
    normals head a constant +y bias, which splits a camera's rays into
    masked and unmasked ones (tests/test_model_kernel_glue.py)."""
    tree = jax.tree.map(np.asarray,
                        jfield.init_field_params(jax.random.PRNGKey(seed)))
    if crafted_normals:
        tree["normals"]["w"] = np.zeros_like(tree["normals"]["w"])
        tree["normals"]["b"] = np.asarray([0.0, 5.0, 0.0], np.float32)
    return tree


def port_field(tree) -> Field:
    field = Field()
    field.load_state_dict(params_from_rsn(tree))
    return field.eval()


def jax_params(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def random_rays(rng: np.random.Generator, num: int):
    """Rays from a radius-4 shell towards the unit ball: numpy
    (origins, unit directions, pixel_area)."""
    o = rng.normal(size=(num, 3)).astype(np.float32)
    o *= 4.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(-0.8, 0.8, size=(num, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pa = rng.uniform(1e-6, 4e-5, size=(num, 1)).astype(np.float32)
    return o, d.astype(np.float32), pa


def facing_rays(num: int):
    """Rays from (0, 0, 4): the first half look at the scene, the second
    half point away -> numpy (origins, unit directions, pixel_area)."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(num, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: num // 2, 2] = -np.abs(d[: num // 2, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.array([0.0, 0.0, 4.0], np.float32),
                        (num, 3)).copy()
    pa = np.full((num, 1), 1e-6, np.float32)
    return o, d, pa


def assert_grads(got, ref, tol, tols=None):
    """Each gradient of an rsn-layout tree within tol of its max |value|
    (tols: per (name, layer index) exceptions)."""
    for name in ref:
        layers = got[name] if isinstance(got[name], list) else [got[name]]
        refs = ref[name] if isinstance(ref[name], list) else [ref[name]]
        for i, (a, b) in enumerate(zip(layers, refs)):
            limit = (tols or {}).get((name, i), tol)
            for k in ("w", "b"):
                scale = max(float(np.abs(b[k]).max()), 1e-12)
                err = float(np.abs(a[k] - b[k]).max())
                assert err <= limit * scale, (name, i, k, err, scale)


def bundles(o, d, pa, near: float = 2.0, far: float = 6.0):
    """The same rays as an rsn and an rsn_torch RayBundle."""
    nears = np.full((o.shape[0], 1), near, np.float32)
    fars = np.full((o.shape[0], 1), far, np.float32)
    jb = JRayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                    pixel_area=jnp.asarray(pa), nears=jnp.asarray(nears),
                    fars=jnp.asarray(fars))
    tb = TRayBundle(origins=t(o), directions=t(d), pixel_area=t(pa),
                    nears=t(nears), fars=t(fars))
    return jb, tb
