"""Run-dir IO of the port: rsn's config.json reader (jax-free, reused)
and the torch checkpoint loader (port of rsn.cli.run_io.load_run_full)."""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from rsn.cli.run_io import load_config
from rsn.configs import TrainerConfig
from rsn_torch.engine import checkpoints as ckpt_lib
from rsn_torch.models.field import Field

__all__ = ["load_config", "load_run_full"]


def load_run_full(run_dir: str, device="cpu"
                  ) -> Tuple[Field, TrainerConfig, int, Dict[str, Any]]:
    """-> (field on `device`, config, step, extras) from the run dir's
    latest checkpoint.  extras holds the optional state groups (camera
    deltas, proposal field); the port's checkpoints have none yet."""
    config = load_config(run_dir)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    path = ckpt_lib.latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state = ckpt_lib.load_checkpoint(path)
    field = Field()
    field.load_state_dict(state["field"])
    return field.to(device).eval(), config, int(state["step"]), {}
