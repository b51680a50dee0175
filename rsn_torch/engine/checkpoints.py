"""Checkpoints of the port and the weight carry to and from rsn (port of
rsn.engine.checkpoints).

A checkpoint is `checkpoints/step-XXXXXXXXX.pt` (torch.save of
{"step", "field"}, and from a trainer also "optimizer", "scheduler" and
"trainer": the optimizer and schedule state and the host-side trainer
state, such as the adaptive reflect-fraction controller; a preset run adds
"proposal", "proposal_optimizer" and "proposal_scheduler", a run with the
camera optimizer "camera" (the (N, 6) pose deltas), "camera_optimizer"
and "camera_scheduler"); the run's
config sits beside it as config.json, readable by both packages'
load_config.  `params_from_rsn` maps rsn's
params pytree (numpy, (in, out) weights) to the port's Field state dict
((out, in) weights) and `params_to_rsn` maps it back;
`proposal_from_rsn` / `proposal_to_rsn` do the same for the proposal
field ({"trunk": [{"w", "b"}] * 4, "density": {"w", "b"}}).
`convert_torch_state_dict` / `export_torch_state_dict` read and write the
reference field's torch state dict (nerfstudio names: mlp_base.layers.N,
mlp_mid.layers.0, field_output_*.net; port of
rsn/engine/checkpoints.py:131-192) through the rsn pytree, so
params_from_rsn / params_to_rsn stay the one carry.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from rsn_torch.models.field import TRUNK_LAYERS
from rsn_torch.models.proposal import PROP_LAYERS

# rsn params key -> reference / port module name
HEAD_MAP = {
    "density": "field_output_density",
    "low": "field_output_low",
    "bottleneck": "field_output_bottleneck",
    "mid": "field_output_mid",
    "normals": "field_output_normals",
    "roughness": "field_output_roughness",
    "diff": "field_output_diff",
    "tint": "field_output_tint",
}


def _module_names():
    yield from ((("trunk", i), f"mlp_base.layers.{i}")
                for i in range(TRUNK_LAYERS))
    yield ("mid_mlp", None), "mlp_mid.layers.0"
    yield from (((k, None), f"{v}.net") for k, v in HEAD_MAP.items())


def _rsn_layer(tree, key):
    name, i = key
    return tree[name][i] if i is not None else tree[name]


def params_from_rsn(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """rsn params pytree ({"trunk": [{"w", "b"}] * 8, "density": {...},
    ...}, numpy arrays) -> Field state dict."""
    sd = {}
    for key, module in _module_names():
        layer = _rsn_layer(tree, key)
        sd[f"{module}.weight"] = torch.from_numpy(
            np.array(np.asarray(layer["w"], np.float32).T, order="C"))
        sd[f"{module}.bias"] = torch.from_numpy(
            np.array(layer["b"], np.float32))
    return sd


def params_to_rsn(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Field state dict -> rsn params pytree of numpy arrays."""
    def layer(module):
        return {"w": np.ascontiguousarray(
                    state_dict[f"{module}.weight"].detach().cpu().numpy().T),
                "b": state_dict[f"{module}.bias"].detach().cpu().numpy()}

    tree: Dict[str, Any] = {"trunk": []}
    for (name, i), module in _module_names():
        if i is not None:
            tree["trunk"].append(layer(module))
        else:
            tree[name] = layer(module)
    return tree


def proposal_from_rsn(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """rsn proposal params ({"trunk": [{"w", "b"}] * 4, "density": {...}},
    numpy, (in, out) weights) -> ProposalField state dict."""
    layers = [(f"trunk.{i}", layer) for i, layer in enumerate(tree["trunk"])]
    sd = {}
    for module, layer in layers + [("density", tree["density"])]:
        sd[f"{module}.weight"] = torch.from_numpy(
            np.array(np.asarray(layer["w"], np.float32).T, order="C"))
        sd[f"{module}.bias"] = torch.from_numpy(
            np.array(layer["b"], np.float32))
    return sd


def proposal_to_rsn(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """ProposalField state dict -> rsn proposal params of numpy arrays."""
    def layer(module):
        return {"w": np.ascontiguousarray(
                    state_dict[f"{module}.weight"].detach().cpu().numpy().T),
                "b": state_dict[f"{module}.bias"].detach().cpu().numpy()}

    return {"trunk": [layer(f"trunk.{i}") for i in range(PROP_LAYERS)],
            "density": layer("density")}


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_checkpoint(ckpt_dir: str, step: int, field: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None,
                    trainer_state: Optional[Dict[str, Any]] = None,
                    proposal: Optional[torch.nn.Module] = None,
                    proposal_optimizer: Optional[torch.optim.Optimizer] = None,
                    proposal_scheduler=None,
                    camera: Optional[torch.Tensor] = None,
                    camera_optimizer: Optional[torch.optim.Optimizer] = None,
                    camera_scheduler=None) -> str:
    """Write step-XXXXXXXXX.pt (atomically: a temporary file, then a
    rename) and return its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step-{step:09d}.pt")
    state: Dict[str, Any] = {"step": step, "field": _cpu_state(field)}
    if proposal is not None:
        state["proposal"] = _cpu_state(proposal)
    if camera is not None:
        state["camera"] = camera.detach().cpu()
    for key, obj in (("optimizer", optimizer), ("scheduler", scheduler),
                     ("proposal_optimizer", proposal_optimizer),
                     ("proposal_scheduler", proposal_scheduler),
                     ("camera_optimizer", camera_optimizer),
                     ("camera_scheduler", camera_scheduler)):
        if obj is not None:
            state[key] = obj.state_dict()
    if trainer_state is not None:
        state["trainer"] = trainer_state
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step-") and d.endswith(".pt"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """-> {"step": int, "field": state dict on the CPU, and what the
    writer added ("optimizer", "scheduler", "trainer", "proposal",
    "proposal_optimizer", "proposal_scheduler", "camera",
    "camera_optimizer", "camera_scheduler")}."""
    return torch.load(path, map_location="cpu", weights_only=True)


def dump_config(run_dir: str, config) -> None:
    """config.json of a run (the layout both packages' load_config read)."""
    def to_dict(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: to_dict(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, dict):
            return {k: to_dict(v) for k, v in obj.items()}
        return obj

    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(to_dict(config), f, indent=2)


def convert_torch_state_dict(state_dict: Dict[str, Any],
                             prefix: str = "field.") -> Dict[str, torch.Tensor]:
    """A reference-field torch state dict (tensors or numpy arrays; keys
    `<prefix>mlp_base.layers.N.weight`, `<prefix>field_output_*.net.*`,
    the prefix optional) -> the port's Field state dict, through rsn's
    params pytree."""
    def get(name: str) -> np.ndarray:
        for k in (prefix + name, name):
            if k in state_dict:
                v = state_dict[k]
                return np.asarray(v.detach().cpu().numpy()
                                  if hasattr(v, "detach") else v, np.float32)
        raise KeyError(f"missing torch key {prefix + name}")

    tree: Dict[str, Any] = {"trunk": []}
    for (name, i), module in _module_names():
        layer = {"w": np.ascontiguousarray(get(module + ".weight").T),
                 "b": get(module + ".bias")}
        if i is not None:
            tree["trunk"].append(layer)
        else:
            tree[name] = layer
    return params_from_rsn(tree)


def export_torch_state_dict(state_dict: Dict[str, torch.Tensor],
                            prefix: str = "field.") -> Dict[str, np.ndarray]:
    """The port's Field state dict -> the reference field's torch state
    dict of numpy arrays (the inverse of convert_torch_state_dict)."""
    tree = params_to_rsn(state_dict)
    out: Dict[str, np.ndarray] = {}
    for key, module in _module_names():
        layer = _rsn_layer(tree, key)
        out[f"{prefix}{module}.weight"] = np.asarray(layer["w"]).T
        out[f"{prefix}{module}.bias"] = np.asarray(layer["b"])
    return out
