"""rsn_torch train — the port of rsn-train (the `ns-train` equivalent).

    python -m rsn_torch.cli.train reflect-sampling-nerf \
        --data sphere:res=800 --pipeline.datamanager.dataparser synthetic \
        --pipeline.model.compute-dtype bfloat16 [--max-num-iterations N]
    python -m rsn_torch.cli.train reflect-sampling-nerf ... \
        --load-dir RUN/checkpoints
    python -m rsn_torch.cli.train reflect-sampling-nerf-proposal \
        --data sphere:res=800 --pipeline.datamanager.dataparser synthetic \
        --pipeline.model.compute-dtype bfloat16 \
        [--pipeline.model.use-pallas-proposal True]

The same flags as rsn-train (every config field, through the port's copy
of parse_config).  Writes <output-dir>/<experiment>/<method>/<timestamp>/
with config.json, train_log.jsonl and step-indexed checkpoints.  Trains
on the CUDA card, and raises when torch sees none; a Python caller may
ask for the CPU with main(argv, device="cpu").  Multi-host runs
(--multihost and its three flags) are a later step of the port.
"""
from __future__ import annotations

import sys

from rsn_torch.cli.registry import METHODS, get_method
from rsn_torch.configs import TrainerConfig
from rsn_torch.utils.cli import apply_overrides, parse_config


def main(argv=None, device=None) -> int:
    """The CLI; device: the caller's choice of device (default the card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = "\n  ".join(f"{k}: {v.description}"
                            for k, v in METHODS.items())
        print("usage: python -m rsn_torch.cli.train METHOD [flags]\n\n"
              f"methods:\n  {names}\n\nrun with METHOD --help for all flags")
        return 0
    method = argv.pop(0)
    base = get_method(method).config_factory()
    cfg, extras = parse_config(
        TrainerConfig, argv, description=f"train {method}",
        extra_args={
            "--data": dict(type=str, default=None,
                           help="dataset (shortcut for "
                                "--pipeline.datamanager.data)"),
            "--load-dir": dict(type=str, default=None, dest="load_dir",
                               help="resume from a checkpoints dir"),
            "--multihost": dict(action="store_true", dest="multihost"),
            "--coordinator-address": dict(type=str, default=None,
                                          dest="coordinator_address"),
            "--num-processes": dict(type=int, default=None,
                                    dest="num_processes"),
            "--process-id": dict(type=int, default=None, dest="process_id"),
        }, base=base)
    if extras.multihost or extras.num_processes or extras.coordinator_address:
        raise NotImplementedError(
            "multi-host training: ROADMAP Queue 1 step 13 (data-parallel "
            "mesh) is not ported")
    if extras.data:
        cfg = apply_overrides(cfg, {"pipeline.datamanager.data": extras.data})

    from rsn_torch.cli.run_io import entry_device
    from rsn_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, device=entry_device(device))
    if extras.load_dir:
        trainer.restore(extras.load_dir)
    print(f"run dir: {trainer.run_dir} (1 device: {trainer.device})",
          flush=True)
    trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
