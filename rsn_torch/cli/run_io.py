"""Run-dir IO of the port: config.json (the port's copy of
rsn.cli.run_io.load_config, same layout) and the torch checkpoint loader
(port of rsn.cli.run_io.load_run_full)."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from rsn_torch.configs import (BugCompat, DataManagerConfig, ModelConfig,
                               OptimizerGroupConfig, PipelineConfig,
                               TrainerConfig)
from rsn_torch.engine import checkpoints as ckpt_lib
from rsn_torch.models.field import Field
from rsn_torch.models.proposal import ProposalField


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    sub = {"pipeline": PipelineConfig, "datamanager": DataManagerConfig,
           "model": ModelConfig, "bug_compat": BugCompat}
    for k, v in d.items():
        if k not in hints:
            continue
        if k in sub and isinstance(v, dict):
            kwargs[k] = _from_dict(sub[k], v)
        elif k == "optimizers" and isinstance(v, dict):
            kwargs[k] = {name: OptimizerGroupConfig(**g)
                         for name, g in v.items()}
        else:
            kwargs[k] = v
    return cls(**kwargs)


def entry_device(device: Optional[str] = None) -> torch.device:
    """The device of an entry point: the CUDA card unless the caller asks
    for another (a Python caller's device="cpu").  Raises when CUDA is
    asked for and torch sees no card: an entry point never drops to the
    CPU by itself."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torch sees no CUDA card: the entry points run on the card "
            "(a Python caller may pass device='cpu' to main())")
    return dev


def load_config(run_dir: str) -> TrainerConfig:
    with open(os.path.join(run_dir, "config.json")) as f:
        return _from_dict(TrainerConfig, json.load(f))


def load_run_full(run_dir: str, device="cpu"
                  ) -> Tuple[Field, TrainerConfig, int, Dict[str, Any]]:
    """-> (field on `device`, config, step, extras) from the run dir's
    latest checkpoint.  extras holds the optional state groups: "proposal"
    (a ProposalField on `device`) for a preset run, "camera" (the (N, 6)
    pose deltas on `device`) for a run with the camera optimizer."""
    config = load_config(run_dir)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    path = ckpt_lib.latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state = ckpt_lib.load_checkpoint(path)
    field = Field()
    field.load_state_dict(state["field"])
    extras: Dict[str, Any] = {}
    if "proposal" in state:
        prop = ProposalField()
        prop.load_state_dict(state["proposal"])
        extras["proposal"] = prop.to(device).eval()
    if "camera" in state:
        extras["camera"] = state["camera"].to(device)
    return field.to(device).eval(), config, int(state["step"]), extras
