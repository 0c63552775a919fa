"""Checkpoints of the whole train state: parameters, and the optimizer's
state with Adam's step and moments and the (decayed) learning rate in its
``param_groups``.

Counterpart of ``ihgnn_tpu/train/checkpoint.py``, stored the reference's
way (Main.py:195-214, 252-262): one ``torch.save`` file of
``{"epoch_count", "model": state_dict, "optimizer": state_dict}`` under
``<result_dir>/checkpoint_<stamp>_epoch<N>``. ``latest`` names the
lexicographically last ``checkpoint_*`` entry. Under a mesh
(``--mesh_data``) rank 0 alone saves, and every rank restores rank 0's
file (``cli.py``), so no two ranks stamp a checkpoint from their own
clocks.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


def checkpoint_name(epoch: int) -> str:
    stamp = time.strftime("%y%m%d-%H%M%S", time.localtime())
    return f"checkpoint_{stamp}_epoch{epoch}"


def save_checkpoint(result_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> str:
    """Write the state under ``result_dir``; returns the file's name."""
    name = checkpoint_name(epoch)
    torch.save({"epoch_count": epoch, "model": model.state_dict(),
                "optimizer": optimizer.state_dict()},
               os.path.join(result_dir, name))
    return name


def find_latest(result_dir: str) -> Optional[str]:
    if not os.path.isdir(result_dir):
        return None
    names = sorted(n for n in os.listdir(result_dir)
                   if n.startswith("checkpoint_"))
    return names[-1] if names else None


def restore_checkpoint(result_dir: str, name: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> int:
    """Load checkpoint ``name`` (or ``latest``) into ``model`` and
    ``optimizer`` and return its epoch. The optimizer must already hold the
    model's parameters on their device.

    The file is read onto the CPU: ``load_state_dict`` copies the
    parameters and Adam's moments onto the parameters' device and leaves
    Adam's step counters on the CPU, where a fresh run keeps them. A step
    counter on the card would make every later Adam step read it back to
    the host."""
    if name == "latest":
        resolved = find_latest(result_dir)
        if resolved is None:
            raise FileNotFoundError(f"no checkpoint_* in {result_dir}")
        name = resolved
    saved = torch.load(os.path.join(result_dir, name), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(saved["model"])
    optimizer.load_state_dict(saved["optimizer"])
    return int(saved["epoch_count"])
