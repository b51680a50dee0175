"""The optimizer table (port of rsn.engine.optimizers).

  fields:            RAdam(lr 1e-3, eps 1e-15), exponential decay -> 1e-4 at 50k
  proposal_networks: Adam(lr 1e-3, eps 1e-15), exponential decay -> 1e-4 at 200k

"fields" binds the field's parameters; "proposal_networks" binds the
proposal field's in proposal mode (the trainer builds it then; in the
reference it binds none, SURVEY.md B#6); camera_opt binds none yet.  The
decay is nerfstudio's ExponentialDecayScheduler without warmup,
lr(t) = lr_init (lr_final / lr_init)^(min(t, T) / T), as a LambdaLR
multiplier of lr_init: step t (counted from 0) runs at lr(t), as optax's
schedule does.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from rsn_torch.configs import OptimizerGroupConfig


def exponential_decay(lr_init: float, lr_final: float,
                      max_steps: int) -> Callable[[int], float]:
    """-> the multiplier of lr_init at step t."""
    def factor(count: int) -> float:
        return (lr_final / lr_init) ** (min(count, max_steps) / max_steps)
    return factor


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    cfg: OptimizerGroupConfig
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """-> (optimizer, scheduler); call scheduler.step() after each
    optimizer.step()."""
    if cfg.optimizer == "radam":
        opt = torch.optim.RAdam(params, lr=cfg.lr, eps=cfg.eps)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, eps=cfg.eps)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, exponential_decay(cfg.lr, cfg.lr_final, cfg.max_steps))
    return opt, sched


def build_field_optimizer(field: torch.nn.Module,
                          optimizers: Dict[str, OptimizerGroupConfig]):
    """The single live parameter group ("fields")."""
    return build_optimizer(field.parameters(), optimizers["fields"])
