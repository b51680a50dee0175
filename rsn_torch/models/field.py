"""The reflect-sampling NeRF field as a torch.nn.Module (port of
rsn.models.field).

Submodules carry the reference's nerfstudio names, so the state dict
reads like the reference's (`mlp_base.layers.N`, `mlp_mid.layers.0`,
`field_output_{density,low,bottleneck,mid,normals,roughness,diff,
tint}.net`).  Weights are torch-layout (out, in); init is nn.Linear's
distribution, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
drawn from an explicit torch.Generator.

`dtype=torch.bfloat16` reproduces rsn's mixed precision: matmul operands
rounded to bf16 with fp32 accumulation, activations between trunk
layers stored in bf16, everything else fp32.  torch's `bf16 @ bf16`
returns bf16 (an extra rounding JAX's preferred_element_type does not
have), so `MatmulBF16` rounds the operands, upcasts them and multiplies
in fp32 — exact products, fp32 sums — and its backward is rsn's
`_matmul_bf16`'s: the cotangent rounded to bf16 before the dgrad and the
wgrad, dx returned bf16, dW fp32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from rsn_torch.core.encodings import (_BAND_SLICES, IPE_OUT_DIM,
                                      ISH_OUT_DIM, ipe_encode, sh_basis)
from rsn_torch.core.render import normalize

TRUNK_WIDTH = 256
TRUNK_LAYERS = 8
SKIP_AT = 4
MID_WIDTH = 128
DENSITY_BIAS = 0.5

BF16 = torch.bfloat16


def _linear(in_dim: int, out_dim: int,
            generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    bound = 1.0 / in_dim ** 0.5
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class _MLP(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Head(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, generator):
        super().__init__()
        self.net = _linear(in_dim, out_dim, generator)


class MatmulBF16(torch.autograd.Function):
    """xb @ weight.T with bf16 operands and fp32 accumulation, and a bf16
    backward (rsn.models.field._matmul_bf16).  xb must already be bf16;
    weight is the fp32 (out, in) parameter, whose gradient stays fp32."""

    @staticmethod
    def forward(ctx, xb, weight):
        wb = weight.to(BF16)
        ctx.save_for_backward(xb, wb)
        return F.linear(xb.float(), wb.float())

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(BF16).float()
        dx = (gb @ wb.float()).to(BF16)
        dw = gb.reshape(-1, gb.shape[-1]).t() @ xb.reshape(
            -1, xb.shape[-1]).float()
        return dx, dw


def _dense(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ weight.T + bias; with dtype=bf16 (or a bf16 x) the operands
    are bf16-rounded and multiplied in fp32, the bias added in fp32."""
    if dtype is None and x.dtype in (torch.bfloat16, torch.float16):
        dtype = x.dtype
    if dtype is not None and dtype != torch.float32:
        y = MatmulBF16.apply(x.to(BF16), weight) + bias
    else:
        y = F.linear(x, weight) + bias
    return y.to(out_dtype) if out_dtype is not None else y


def _apply(layer: nn.Linear, x: torch.Tensor, dtype=None, out_dtype=None):
    return _dense(layer.weight, layer.bias, x, dtype, out_dtype)


class Field(nn.Module):
    """Trunk MLP 8x256 (skip at layer 4) + the decomposed heads."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        trunk = []
        for i in range(TRUNK_LAYERS):
            d_in = IPE_OUT_DIM if i == 0 else TRUNK_WIDTH
            if i == SKIP_AT:
                d_in = TRUNK_WIDTH + IPE_OUT_DIM
            trunk.append(_linear(d_in, TRUNK_WIDTH, g))
        self.mlp_base = _MLP(trunk)
        self.field_output_density = _Head(TRUNK_WIDTH, 1, g)
        self.field_output_low = _Head(TRUNK_WIDTH, 3, g)  # dead head
        self.field_output_bottleneck = _Head(TRUNK_WIDTH, TRUNK_WIDTH, g)
        self.mlp_mid = _MLP([_linear(ISH_OUT_DIM + TRUNK_WIDTH, MID_WIDTH,
                                     g)])
        self.field_output_mid = _Head(MID_WIDTH, 3, g)
        self.field_output_normals = _Head(TRUNK_WIDTH, 3, g)
        self.field_output_roughness = _Head(TRUNK_WIDTH, 1, g)
        self.field_output_diff = _Head(TRUNK_WIDTH, 3, g)
        self.field_output_tint = _Head(TRUNK_WIDTH, 3, g)

    # ---- trunk + heads -------------------------------------------------

    def trunk(self, x: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """8 linears, ReLU after each, input re-concatenated at layer 4;
        in bf16 the activations between layers are bf16."""
        act = None if dtype == torch.float32 else dtype
        h = x if act is None else x.to(act)
        for i, layer in enumerate(self.mlp_base.layers):
            if i == SKIP_AT:
                h = torch.cat([x.to(h.dtype), h], dim=-1)
            h = torch.relu(_apply(layer, h, dtype, out_dtype=act))
        return h

    def get_density(self, mean: torch.Tensor, cov_diag: torch.Tensor,
                    dtype: torch.dtype = torch.float32):
        """-> (density, embedding, density_preact);
        density = softplus(linear(trunk(IPE)) + 0.5)."""
        emb = self.trunk(ipe_encode(mean, cov_diag), dtype)
        preact = _apply(self.field_output_density.net, emb)
        return F.softplus(preact + DENSITY_BIAS), emb, preact

    def get_analytic_normals(self, mean: torch.Tensor, cov_diag: torch.Tensor,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
        """-normalize(d density_preact / d mean), cov held fixed, on
        (N, 3) rows; a detached regularization target
        (rsn.models.field.get_analytic_normals).  The parameters' .grad
        are not touched."""
        with torch.enable_grad():
            m = mean.detach().requires_grad_(True)
            _, _, preact = self.get_density(m, cov_diag.detach(), dtype)
            (g,) = torch.autograd.grad(preact.sum(), m)
        return (-normalize(g)).detach()

    def get_field_outputs(self, mean: torch.Tensor, cov_diag: torch.Tensor,
                          dtype: torch.dtype = torch.float32,
                          use_pallas: bool = False,
                          differentiable: bool = True
                          ) -> Dict[str, torch.Tensor]:
        """One trunk evaluation -> every per-sample head, on (N, C) rows
        (the batch is flattened like rsn's, so the density equals the
        density-only pass bit for bit).  With use_pallas and not
        differentiable, the kernel route: K11 (field_forward_v2, bf16
        whatever dtype, as in rsn) on the (N, 16) rows [mean | cov_diag |
        0], then rsn's post-processing of its raw heads."""
        if use_pallas and not differentiable:
            return self._field_outputs_kernel(mean, cov_diag)
        batch_shape = mean.shape[:-1]
        density, emb, preact = self.get_density(
            mean.reshape(-1, 3), cov_diag.reshape(-1, 3), dtype)
        act = None if dtype == torch.float32 else dtype
        out = {
            "density": density,
            "density_preact": preact,
            "diff": self.get_diff(emb),
            "tint": self.get_tint(emb),
            "rough_raw": _apply(self.field_output_roughness.net, emb),
            "pred_normals": self.get_pred_normals(emb),
            "bottleneck": _apply(self.field_output_bottleneck.net, emb,
                                 dtype, out_dtype=act),
        }
        return {k: v.reshape(*batch_shape, v.shape[-1])
                for k, v in out.items()}

    @torch.no_grad()
    def _field_outputs_kernel(self, mean: torch.Tensor,
                              cov_diag: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
        # the kernels' module imports this one
        from rsn_torch.kernels import field_forward as ff

        batch_shape = mean.shape[:-1]
        mean, cov_diag = mean.reshape(-1, 3), cov_diag.reshape(-1, 3)
        pad = torch.zeros(mean.shape[0], ff.IN_COLS - 6, device=mean.device)
        mc = torch.cat([mean.float(), cov_diag.float(), pad],
                       dim=-1).contiguous()
        h = ff.unpack_outputs(ff.field_forward_v2(ff.pack_params(self), mc))
        preact = h["density_preact"]
        out = {
            "density": F.softplus(preact + DENSITY_BIAS),
            "density_preact": preact,
            "diff": torch.sigmoid(h["diff_raw"]),
            "tint": torch.sigmoid(h["tint_raw"]),
            "rough_raw": h["rough_raw"],
            "pred_normals": normalize(-h["normals_raw"]),
            "bottleneck": h["bottleneck"],
        }
        return {k: v.reshape(*batch_shape, v.shape[-1])
                for k, v in out.items()}

    def get_pred_normals(self, emb: torch.Tensor) -> torch.Tensor:
        return normalize(-_apply(self.field_output_normals.net, emb))

    def get_roughness(self, emb: torch.Tensor,
                      activation=torch.sigmoid) -> torch.Tensor:
        """roughness_bias is declared by the reference but never applied
        (SURVEY.md B#7)."""
        return activation(_apply(self.field_output_roughness.net, emb))

    def get_diff(self, emb: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(_apply(self.field_output_diff.net, emb))

    def get_tint(self, emb: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(_apply(self.field_output_tint.net, emb))

    # ---- directional branch -------------------------------------------

    def mid_weights(self):
        """(w_enc (34, 128), w_emb (256, 128), b) of the mid-MLP's first
        linear in (in, out) layout: rows [ISH(34) | bottleneck(256)]."""
        layer = self.mlp_mid.layers[0]
        w = layer.weight.t()
        return w[:ISH_OUT_DIM], w[ISH_OUT_DIM:], layer.bias

    def get_mid_factored(self, ray_dirs: torch.Tensor,
                         roughness: torch.Tensor, bottleneck: torch.Tensor,
                         sh_l8_m7_2x: bool = True,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """get_mid for samples whose direction is the ray's:
        [ISH || emb] @ W = sum_band exp(-rough k_b) (basis_b @ W_enc_b)
        + emb @ W_emb, the basis once per ray.

        ray_dirs (R, 3); roughness (R, S, 1); bottleneck (R, S, 256)."""
        basis = sh_basis(ray_dirs, sh_l8_m7_2x)  # (R, 34)
        w_enc, w_emb, b = self.mid_weights()
        act = None if dtype == torch.float32 else dtype
        batch_shape = bottleneck.shape[:-1]
        flat = bottleneck.reshape(-1, bottleneck.shape[-1])
        pre = _dense(w_emb.t(), b, flat, dtype).reshape(*batch_shape,
                                                         MID_WIDTH)
        for lo, hi, k in _BAND_SLICES:
            g = basis[..., lo:hi] @ w_enc[lo:hi]  # (R, 128)
            pre = pre + torch.exp(-roughness * k) * g[..., None, :]
        h = torch.relu(pre)
        if act is not None:
            h = h.to(act)
        out = torch.sigmoid(_apply(self.field_output_mid.net,
                                   h.reshape(-1, MID_WIDTH)))
        return out.reshape(*batch_shape, 3)

    def get_low(self, emb: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Zero-direction readout through the bottleneck and mid-MLP."""
        act = None if dtype == torch.float32 else dtype
        emb = _apply(self.field_output_bottleneck.net, emb, dtype,
                     out_dtype=act)
        zeros = torch.zeros(*emb.shape[:-1], ISH_OUT_DIM, dtype=emb.dtype,
                            device=emb.device)
        h = torch.relu(_apply(self.mlp_mid.layers[0],
                              torch.cat([zeros, emb], dim=-1), dtype,
                              out_dtype=act))
        return torch.sigmoid(_apply(self.field_output_mid.net, h))

    def get_inf_color(self, directions: torch.Tensor, sqradius: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Far-field radiance: the field at mean 2d with covariance
        diagonal 0.6 sqradius (1 - d*d), ReLU-clamped because rounding
        can make 1 - d_i^2 slightly negative (an exp overflow to inf in
        the IPE damping otherwise)."""
        mean = 2.0 * directions
        cov_diag = 0.6 * sqradius * torch.relu(1.0 - directions * directions)
        _, emb, _ = self.get_density(mean, cov_diag, dtype)
        return self.get_low(emb, dtype)


def get_reflection(directions: torch.Tensor, normals: torch.Tensor):
    """Mirror reflection and n.d (reference field.py:203-207)."""
    n_dot_d = (directions * normals).sum(dim=-1, keepdim=True)
    return normalize(directions - 2.0 * n_dot_d * normals), n_dot_d
