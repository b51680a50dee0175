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

    # data-parallel: N local ranks, one per card (rsn's num_devices)
    python -m rsn_torch.cli.train reflect-sampling-nerf ... --num-devices N
    # one process of a group of several (hosts): rank process_id
    python -m rsn_torch.cli.train reflect-sampling-nerf ... --multihost \
        --coordinator-address HOST:PORT --num-processes P --process-id I
    # or under torchrun, which sets the rendezvous itself
    torchrun --nproc-per-node N -m rsn_torch.cli.train ... --multihost

The same flags as rsn-train (every config field, through the port's copy
of parse_config).  Writes <output-dir>/<experiment>/<method>/<timestamp>/
with config.json, train_log.jsonl and step-indexed checkpoints.  Trains
on the CUDA card, and raises when torch sees none; a Python caller may
ask for the CPU with main(argv, device="cpu"), which every rank then
takes (gloo between CPU ranks).

Several devices (rsn_torch.parallel.mesh): rsn's num_devices is the
group's size (0: every visible card; one rank on the CPU).  Without
--multihost, a size above 1 spawns that many local ranks; with it, this
process joins a group of num_processes processes at the coordinator (or
torchrun's environment) and owns num_devices / num_processes of its ranks
(every visible card for 0), spawning them when there are several.
Rank 0 prints the run dir and writes the run.
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
    cfg, extras = parse_args(argv)
    group_flags = (extras.coordinator_address, extras.num_processes,
                   extras.process_id)
    if not extras.multihost and any(f is not None for f in group_flags):
        raise ValueError("--coordinator-address, --num-processes and "
                         "--process-id join a group with --multihost")

    from rsn_torch.cli.run_io import entry_device
    from rsn_torch.parallel import mesh as mesh_lib

    device = str(entry_device(device))
    if not extras.multihost:
        k = mesh_lib.local_ranks_for(cfg.num_devices, 1, device)
        if k > 1:
            mesh_lib.launch(train_rank, k, (cfg, extras.load_dir),
                            device=device)
        else:
            train_rank(None, cfg, extras.load_dir, device)
        return 0
    if extras.coordinator_address is None:  # torchrun's environment
        mesh = mesh_lib.init_mesh(device)
        train_rank(mesh, cfg, extras.load_dir)
        mesh_lib.close(mesh)
        return 0
    if None in group_flags:
        raise ValueError("--coordinator-address needs --num-processes and "
                         "--process-id")
    k = mesh_lib.local_ranks_for(cfg.num_devices, extras.num_processes,
                                 device)
    group = dict(coordinator_address=extras.coordinator_address,
                 num_processes=extras.num_processes,
                 process_id=extras.process_id)
    if k > 1:
        mesh_lib.launch(train_rank, k, (cfg, extras.load_dir),
                        device=device, **group)
    else:
        mesh = mesh_lib.init_mesh(device, **group)
        train_rank(mesh, cfg, extras.load_dir)
        mesh_lib.close(mesh)
    return 0


def parse_args(argv):
    """METHOD and its flags -> (the run's config, the CLI's other flags:
    data, load_dir, multihost, coordinator_address, num_processes,
    process_id)."""
    method, *argv = argv
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
    if extras.data:
        cfg = apply_overrides(cfg, {"pipeline.datamanager.data": extras.data})
    return cfg, extras


def train_rank(mesh, cfg: TrainerConfig, load_dir=None, device=None) -> None:
    """One rank's run (the whole run without a mesh): the trainer, the
    resume, rank 0's run-dir line, the loop."""
    from rsn_torch.engine.trainer import Trainer

    trainer = Trainer(cfg, device=device, mesh=mesh)
    if load_dir:
        trainer.restore(load_dir)
    if trainer.is_primary:
        print(f"run dir: {trainer.run_dir} ({trainer.num_devices} "
              f"device(s): {trainer.device})", flush=True)
    trainer.train()


if __name__ == "__main__":
    sys.exit(main())
