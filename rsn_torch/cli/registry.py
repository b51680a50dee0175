"""Method registry (the port's own copy of rsn.cli.registry, with the
same names and configs) — the framework's equivalent of nerfstudio's
`nerfstudio.method_configs` entry point (reference pyproject.toml:12-13 +
reflect_sampling_nerf_config.py:27-63).

New methods register a (name -> TrainerConfig factory, description)
pair; the train CLI discovers them by name.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from rsn_torch.configs import TrainerConfig


class MethodSpecification(NamedTuple):
    config_factory: Callable[[], TrainerConfig]
    description: str


METHODS: Dict[str, MethodSpecification] = {}


def register_method(name: str, factory: Callable[[], TrainerConfig],
                    description: str = "") -> None:
    METHODS[name] = MethodSpecification(factory, description)


def get_method(name: str) -> MethodSpecification:
    if name not in METHODS:
        known = ", ".join(sorted(METHODS))
        raise KeyError(f"unknown method '{name}' (known: {known})")
    return METHODS[name]


# --- built-in methods ---------------------------------------------------

register_method(
    "reflect-sampling-nerf",
    lambda: TrainerConfig(method_name="reflect-sampling-nerf"),
    "Ref-NeRF-style reflection-aware NeRF with explicit reflected-ray "
    "resampling (rebuild of 236088/reflect-sampling-nerf).")


def _proposal_config() -> TrainerConfig:
    import dataclasses

    base = TrainerConfig(method_name="reflect-sampling-nerf-proposal")
    # distortion 0.002 closes the preset's quality gap to the parity
    # default (30k full-split 23.59 vs 23.6 PSNR, BASELINE.md r2 ladder);
    # proposal-for-reflect adopted r3 after the A/B at 30k scored
    # +1.1 dB PSNR over the ctrl arm at ~11% higher end-to-end
    # throughput (results/ab30k-{ctrl,propreflect}, BASELINE.md ladder)
    model = dataclasses.replace(base.pipeline.model, use_proposal=True,
                                use_proposal_reflect=True,
                                distortion_loss_mult=0.002)
    return dataclasses.replace(
        base, pipeline=dataclasses.replace(base.pipeline, model=model))


register_method(
    "reflect-sampling-nerf-proposal",
    _proposal_config,
    "reflect-sampling-nerf with proposal-network sampling in place of "
    "the coarse pass (binds the proposal_networks optimizer group).")


def _mipnerf_config() -> TrainerConfig:
    import dataclasses

    base = TrainerConfig(method_name="mipnerf")
    model = dataclasses.replace(base.pipeline.model, use_reflection=False)
    return dataclasses.replace(
        base, pipeline=dataclasses.replace(base.pipeline, model=model))


register_method(
    "mipnerf",
    _mipnerf_config,
    "primary-only model family: the same mip-NeRF-style field and "
    "coarse/fine passes WITHOUT the reflected-ray passes -- for "
    "non-specular scenes and debugging.  Combine with "
    "--pipeline.model.use-proposal True for proposal-network sampling.")
