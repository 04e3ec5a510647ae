"""Checkpoints in the reference's ``torch.save({"model", "config"})`` payload.

The reference implementation, ``scripts/convert_reference_ckpt.py --to-torch``
and :func:`save_checkpoint` all write this payload, named ``model.pt`` /
``model_epoch{E:03d}.pt`` / ``model_final.pt``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch

__all__ = ["load_params", "save_checkpoint", "latest_checkpoint"]


def load_params(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Load ``(state_dict, config)`` from a ``.pt`` payload (tensors and
    plain containers only: ``weights_only=True``). A bare state_dict loads
    with an empty config."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model" in payload:
        return dict(payload["model"]), dict(payload.get("config") or {})
    if isinstance(payload, dict):
        return dict(payload), {}
    raise ValueError(f"{path} holds no state_dict payload")


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    config: Optional[Mapping] = None) -> str:
    """Write ``{"model": state_dict (on the CPU), "config": config}``."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in state_dict.items()},
        "config": dict(config or {}),
    }
    torch.save(payload, path)
    return path


def latest_checkpoint(outdir: str) -> Optional[str]:
    """The newest ``model_epoch{E}.pt`` in ``outdir`` (None when absent)."""
    best: Tuple[int, Optional[str]] = (-1, None)
    if not os.path.isdir(outdir):
        return None
    rx = re.compile(r"model_epoch(\d+)\.pt")
    for name in os.listdir(outdir):
        m = rx.fullmatch(name)
        if m and int(m.group(1)) > best[0]:
            best = (int(m.group(1)), os.path.join(outdir, name))
    return best[1]
