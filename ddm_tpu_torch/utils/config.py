"""Config plumbing: argparse + optional YAML with fill-only-defaults merge.

Port of ``ddm_tpu/utils/config.py`` (pure Python, no JAX): YAML values fill
only arguments still equal to their argparse default (CLI-explicit > YAML >
default; an explicit flag equal to its default is indistinguishable from
unset), and unknown YAML keys raise ``ValueError`` naming the key and file.
PyYAML is imported only when a ``--config`` is given.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

__all__ = ["load_yaml_config", "apply_config"]


def load_yaml_config(path: str) -> Dict[str, Any]:
    """Load a YAML mapping; empty file -> {}; non-mapping -> ValueError."""
    try:
        import yaml
    except ImportError as exc:
        raise RuntimeError(
            "Loading a --config YAML needs the pyyaml package; "
            "install it or drop the flag."
        ) from exc

    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f)
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ValueError(f"Config {path} must be a YAML mapping of parameter names to values.")
    return data


def apply_config(parser: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """Merge ``args.config`` (YAML) into ``args`` with fill-only-defaults."""
    if getattr(args, "config", None) is None:
        return
    for key, value in load_yaml_config(args.config).items():
        if not hasattr(args, key):
            raise ValueError(f"Unknown config key '{key}' in {args.config}")
        if getattr(args, key) == parser.get_default(key):
            setattr(args, key, value)
