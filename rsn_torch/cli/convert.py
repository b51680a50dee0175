"""rsn_torch convert — the port of rsn-convert: move field weights between
the torch reference's checkpoints and the port's run dirs.

    python -m rsn_torch.cli.convert --torch-ckpt step-000029999.ckpt \
        --output RUN [--method M] [--data D] [--dataparser P]
    python -m rsn_torch.cli.convert --load-dir RUN --to-torch weights.ckpt

Import: a reference checkpoint (a nerfstudio Trainer `.ckpt`: torch.save
of {step, pipeline, ...}, the field under `_model.field.`,
`module._model.field.`, `model.field.` or `field.`) becomes a run dir the
port's train / eval / render CLIs load: config.json of the method (its
data and dataparser where given) and a checkpoint with the field, a
freshly initialised optimizer and schedule (the reference's moments do
not carry) and, for a proposal method, a fresh proposal field drawn from
the config's seed (the reference has none).  Export: a run dir becomes a
`.ckpt` in the reference's layout, {"step", "pipeline":
{"_model.field.<name>": tensor}}.  Weights go through the rsn pytree
(engine/checkpoints.py), as rsn's own convert moves them.  Files only: no
device work.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

# nerfstudio state-dict prefixes, most specific first: the Trainer saves
# pipeline.state_dict(), the model under `_model.` (`module._model.` when
# DDP-wrapped, reference pipeline.py:73-77)
_MODEL_PREFIXES = ("_model.field.", "module._model.field.",
                   "model.field.", "field.")


def _extract_field_state(raw) -> dict:
    """The field's tensors of a torch checkpoint dict, prefix removed."""
    if not isinstance(raw, dict):
        raise SystemExit(
            "unrecognized torch checkpoint structure (expected the "
            "nerfstudio Trainer dict {step, pipeline, ...} or a plain "
            f"state dict, got {type(raw).__name__})")
    state = raw.get("pipeline", raw)
    if not isinstance(state, dict):
        raise SystemExit("unrecognized torch checkpoint structure")
    for prefix in _MODEL_PREFIXES:
        sub = {k[len(prefix):]: v for k, v in state.items()
               if k.startswith(prefix)}
        if sub:
            return sub
    raise SystemExit(
        "no field parameters found under any of the known prefixes "
        f"{_MODEL_PREFIXES}; checkpoint keys look like: "
        f"{sorted(state)[:5]} ...")


def import_torch(torch_ckpt: str, output: str, method: str,
                 data: str = "", dataparser: str = "") -> str:
    """Reference .ckpt -> a port run dir at `output`."""
    from rsn_torch.cli.registry import get_method
    from rsn_torch.engine import checkpoints as ckpt_lib
    from rsn_torch.engine.optimizers import (build_field_optimizer,
                                             build_optimizer)
    from rsn_torch.models.field import Field
    from rsn_torch.models.proposal import ProposalField

    raw = torch.load(torch_ckpt, map_location="cpu", weights_only=False)
    step = int(raw.get("step", 0)) if isinstance(raw, dict) else 0
    field_sd = ckpt_lib.convert_torch_state_dict(_extract_field_state(raw),
                                                 prefix="")
    config = get_method(method).config_factory()
    if data or dataparser:  # point the imported run at its dataset
        dm = dataclasses.replace(
            config.pipeline.datamanager,
            data=data or config.pipeline.datamanager.data,
            dataparser=dataparser or config.pipeline.datamanager.dataparser)
        config = dataclasses.replace(config, pipeline=dataclasses.replace(
            config.pipeline, datamanager=dm))
    ckpt_lib.dump_config(output, config)
    field = Field(torch.Generator().manual_seed(config.seed))
    field.load_state_dict(field_sd)
    optimizer, scheduler = build_field_optimizer(field, config.optimizers)
    prop = {}
    if config.pipeline.model.use_proposal:
        # as a fresh trainer draws it
        proposal = ProposalField(torch.Generator().manual_seed(
            config.seed + 2))
        prop_opt, prop_sched = build_optimizer(
            proposal.parameters(), config.optimizers["proposal_networks"])
        prop = dict(proposal=proposal, proposal_optimizer=prop_opt,
                    proposal_scheduler=prop_sched)
    path = ckpt_lib.save_checkpoint(os.path.join(output, "checkpoints"),
                                    step, field, optimizer, scheduler,
                                    **prop)
    print(f"imported step {step}: {torch_ckpt} -> {path}")
    return output


def export_torch(load_dir: str, to_torch: str) -> str:
    """A port run dir -> a reference-layout .ckpt at `to_torch`."""
    from rsn_torch.engine import checkpoints as ckpt_lib

    path = ckpt_lib.latest_checkpoint(os.path.join(load_dir, "checkpoints"))
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {load_dir}")
    state = ckpt_lib.load_checkpoint(path)
    step = int(state["step"])
    pipeline = {"_model." + k: torch.from_numpy(np.asarray(v, np.float32))
                for k, v in ckpt_lib.export_torch_state_dict(
                    state["field"]).items()}
    os.makedirs(os.path.dirname(os.path.abspath(to_torch)), exist_ok=True)
    torch.save({"step": step, "pipeline": pipeline}, to_torch)
    print(f"exported step {step}: {load_dir} -> {to_torch}")
    return to_torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="convert checkpoints between the torch reference "
                    "and the port's run dirs")
    p.add_argument("--torch-ckpt", help="reference .ckpt to import")
    p.add_argument("--output", help="run dir to create on import")
    p.add_argument("--method", default="reflect-sampling-nerf",
                   help="method config written to the imported run dir")
    p.add_argument("--data", default="",
                   help="dataset path for the imported run's config")
    p.add_argument("--dataparser", default="",
                   help="dataparser for the imported run's config "
                        "(blender/nerfstudio/instant-ngp/synthetic)")
    p.add_argument("--load-dir", help="run dir to export")
    p.add_argument("--to-torch", help="torch .ckpt path to write on export")
    ns = p.parse_args(argv)

    if ns.torch_ckpt and ns.load_dir:
        p.error("--torch-ckpt (import) and --load-dir (export) are "
                "mutually exclusive; run two invocations")
    if ns.torch_ckpt:
        if not ns.output:
            p.error("--torch-ckpt requires --output")
        import_torch(ns.torch_ckpt, ns.output, ns.method, data=ns.data,
                     dataparser=ns.dataparser)
        return 0
    if ns.load_dir:
        if not ns.to_torch:
            p.error("--load-dir requires --to-torch")
        export_torch(ns.load_dir, ns.to_torch)
        return 0
    p.error("pass --torch-ckpt/--output (import) or "
            "--load-dir/--to-torch (export)")


if __name__ == "__main__":
    sys.exit(main())
