"""The optimizer table (port of rsn.engine.optimizers).

  fields:            RAdam(lr 1e-3, eps 1e-15), exponential decay -> 1e-4 at 50k
  proposal_networks: Adam(lr 1e-3, eps 1e-15), exponential decay -> 1e-4 at 200k
  camera_opt:        Adam(lr 1e-3, eps 1e-15), exponential decay -> 1e-4 at 5k

"fields" binds the field's parameters; "proposal_networks" binds the
proposal field's in proposal mode, "camera_opt" the pose deltas with
camera_optimizer "SO3xR3" (the trainer builds them then; in the reference
neither binds any, SURVEY.md B#6).  The
decay is nerfstudio's ExponentialDecayScheduler without warmup,
lr(t) = lr_init (lr_final / lr_init)^(min(t, T) / T): step t (counted
from 0) runs at lr(t), as optax's schedule does.

Two forms of one table.  Without a step counter (the CPU), the optimizer
takes a float lr and a LambdaLR multiplier of lr_init writes it after
each step.  With the trainer's step counter (a tensor on a card), the
optimizer is capturable, its lr a tensor on the device, and CounterDecay
writes lr(counter) into it in float32, as rsn traces optax's schedule:
a step captured in a CUDA graph reads the lr anew on every replay.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from rsn_torch.configs import OptimizerGroupConfig


def exponential_decay(lr_init: float, lr_final: float,
                      max_steps: int) -> Callable[[int], float]:
    """-> the multiplier of lr_init at step t."""
    def factor(count: int) -> float:
        return (lr_final / lr_init) ** (min(count, max_steps) / max_steps)
    return factor


def decay_at(cfg: OptimizerGroupConfig, count: torch.Tensor) -> torch.Tensor:
    """The group's lr at the steps in `count` (an integer tensor), float32
    on count's device as rsn's optax schedule traces it: lr_init *
    (lr_final / lr_init) ** (f32(min(count, T)) / f32(T)).  The divisor is
    a tensor: CUDA divides by a host scalar through its reciprocal."""
    f32 = dict(dtype=torch.float32, device=count.device)
    t = (torch.clamp(count, max=cfg.max_steps).to(torch.float32)
         / torch.full((), cfg.max_steps, **f32))
    return cfg.lr * (cfg.lr_final / cfg.lr) ** t


class CounterDecay:
    """The decay of a capturable optimizer on a card: apply() writes
    decay_at(counter) into the optimizer's lr tensor, all on the device;
    the trainer calls it before each optimizer step, so a captured step
    sets the lr of the counter it reads.  step() does nothing: the
    trainer advances the counter.  Built, it holds the counter's lr (a
    caller that steps the optimizer once without the trainer gets it).
    state_dict() holds LambdaLR's last_epoch (a checkpoint written on a
    card restores on the CPU); load_state_dict() takes nothing (the
    trainer sets the counter)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 cfg: OptimizerGroupConfig, counter: torch.Tensor):
        self.cfg, self.counter = cfg, counter
        self.lr = optimizer.param_groups[0]["lr"]
        self.apply()

    def apply(self) -> None:
        self.lr.copy_(decay_at(self.cfg, self.counter))

    def step(self) -> None:
        pass

    def state_dict(self) -> Dict:
        return {"last_epoch": int(self.counter), "lr_lambdas": [None]}

    def load_state_dict(self, state: Dict) -> None:
        pass


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    cfg: OptimizerGroupConfig,
                    counter: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.optim.Optimizer, object]:
    """-> (optimizer, schedule); call schedule.step() after each
    optimizer.step().  counter: the trainer's step counter on a card (the
    capturable form, CounterDecay), None for LambdaLR."""
    if counter is None:
        lr, kw = cfg.lr, {}
    else:
        lr = torch.full((), cfg.lr, dtype=torch.float32,
                        device=counter.device)
        kw = {"capturable": True}
    if cfg.optimizer == "radam":
        opt = torch.optim.RAdam(params, lr=lr, eps=cfg.eps, **kw)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, eps=cfg.eps, **kw)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    if counter is not None:
        return opt, CounterDecay(opt, cfg, counter)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, exponential_decay(cfg.lr, cfg.lr_final, cfg.max_steps))
    return opt, sched


def build_field_optimizer(field: torch.nn.Module,
                          optimizers: Dict[str, OptimizerGroupConfig],
                          counter: Optional[torch.Tensor] = None):
    """The single live parameter group ("fields")."""
    return build_optimizer(field.parameters(), optimizers["fields"], counter)


def load_state(optimizer: torch.optim.Optimizer, schedule,
               optimizer_state: Optional[Dict],
               schedule_state: Optional[Dict]) -> None:
    """A checkpoint's optimizer and schedule state, written on either
    device, into this device's form: loading takes the saved groups'
    lr and capturable flag, so they are set back (the card's lr tensor
    and the steps' counts on the device; on the CPU a float lr, LambdaLR's
    lr_init * factor(last_epoch), which is the value it saved)."""
    if optimizer_state is not None:
        optimizer.load_state_dict(optimizer_state)
    if schedule_state is not None:
        schedule.load_state_dict(schedule_state)
    if isinstance(schedule, CounterDecay):
        for group in optimizer.param_groups:
            group["capturable"], group["lr"] = True, schedule.lr
        for state in optimizer.state.values():
            state["step"] = state["step"].to(
                dtype=torch.float32, device=schedule.counter.device)
        return
    for group, base, factor in zip(optimizer.param_groups,
                                   schedule.base_lrs, schedule.lr_lambdas):
        group["capturable"] = False
        group["lr"] = base * factor(schedule.last_epoch)
