"""Dataclass-tree CLI: every nested config field becomes a flag (the
port's own copy of rsn.utils.cli).

Replaces the tyro-generated flag surface the reference inherits from
nerfstudio (SURVEY.md §2.2 'ns-train CLI' row): any field of the
TrainerConfig tree can be overridden as
`--pipeline.model.num-coarse-samples 64` (dots for nesting, dashes or
underscores both accepted), mirroring tyro's naming.
"""
from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Any, Dict, get_args, get_origin


def _resolve_hints(cls) -> Dict[str, Any]:
    import rsn_torch.configs as configs_mod
    return typing.get_type_hints(
        cls, globalns=vars(configs_mod) | vars(typing))


def add_dataclass_args(parser: argparse.ArgumentParser, cls,
                       prefix: str = "") -> None:
    hints = _resolve_hints(cls)
    for f in dataclasses.fields(cls):
        name = f"{prefix}{f.name}"
        t = hints[f.name]
        origin = get_origin(t)
        if origin is typing.Union:
            args = [a for a in get_args(t) if a is not type(None)]
            t = args[0] if args else str
            origin = get_origin(t)
        if dataclasses.is_dataclass(t):
            add_dataclass_args(parser, t, prefix=f"{name}.")
        elif t is bool:
            parser.add_argument(f"--{name.replace('_', '-')}",
                                dest=name, type=_parse_bool, default=None,
                                metavar="{true,false}")
        elif t in (int, float, str):
            parser.add_argument(f"--{name.replace('_', '-')}",
                                dest=name, type=t, default=None)
        # dicts / complex types are not CLI-overridable (config file only)


def _parse_bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a bool: {v}")


def apply_overrides(cfg, overrides: Dict[str, Any]):
    """Apply {dotted.path: value} overrides to a frozen dataclass tree."""
    for path, value in overrides.items():
        if value is None:
            continue
        cfg = _set_path(cfg, path.split("."), value)
    return cfg


def _set_path(obj, parts, value):
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(
        obj, **{parts[0]: _set_path(child, parts[1:], value)})


def parse_config(cls, argv=None, description: str = "",
                 extra_args: Dict[str, Dict] = None, base=None):
    """Parse argv into an instance of dataclass `cls` + extra flags.

    Returns (config, namespace_of_extra_args).
    """
    parser = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for flag, kwargs in (extra_args or {}).items():
        parser.add_argument(flag, **kwargs)
    add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)
    overrides = {}
    extras = argparse.Namespace()
    extra_dests = {kwargs.get("dest", flag.lstrip("-").replace("-", "_"))
                   for flag, kwargs in (extra_args or {}).items()}
    for k, v in vars(ns).items():
        if k in extra_dests:
            setattr(extras, k, v)
        else:
            overrides[k] = v
    cfg = apply_overrides(base if base is not None else cls(), overrides)
    return cfg, extras
