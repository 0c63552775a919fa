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
clocks. With the tables' rows over the model axis, every rank takes part
in gathering the tables and their Adam moments, and rank 0 saves them in
the one-device format (as ``ihgnn_tpu/cli.py:228-236`` does with
``process_allgather``); a restore cuts each rank's blocks out of it, so a
checkpoint of any mesh resumes on any other, or on one device. The
result directory must then be on a file system every host sees.
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
                    optimizer: torch.optim.Optimizer,
                    mesh=None) -> Optional[str]:
    """Write the state under ``result_dir``; returns the file's name.
    With ``mesh`` every rank calls it, rank 0 writes the one-device state
    and returns its name, the others None."""
    if mesh is None:
        model_state, opt_state = model.state_dict(), optimizer.state_dict()
    else:
        from ihgnn_torch.parallel.tables import (gather_optimizer_state,
                                                 gather_params)
        model_state = gather_params(model)
        opt_state = gather_optimizer_state(optimizer, model)
        if mesh.rank != 0:
            return None
    name = checkpoint_name(epoch)
    torch.save({"epoch_count": epoch, "model": model_state,
                "optimizer": opt_state}, os.path.join(result_dir, name))
    return name


def find_latest(result_dir: str) -> Optional[str]:
    if not os.path.isdir(result_dir):
        return None
    names = sorted(n for n in os.listdir(result_dir)
                   if n.startswith("checkpoint_"))
    return names[-1] if names else None


def restore_checkpoint(result_dir: str, name: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, mesh=None) -> int:
    """Load checkpoint ``name`` (or ``latest``) into ``model`` and
    ``optimizer`` and return its epoch. The optimizer must already hold the
    model's parameters on their device.

    The file is read onto the CPU: ``load_state_dict`` copies the
    parameters and Adam's moments onto the parameters' device and leaves
    Adam's step counters on the CPU, where a fresh run keeps them. A step
    counter on the card would make every later Adam step read it back to
    the host. With ``mesh`` (the tables over its model axis) each rank
    loads its blocks of the tables and of their moments."""
    if name == "latest":
        resolved = find_latest(result_dir)
        if resolved is None:
            raise FileNotFoundError(f"no checkpoint_* in {result_dir}")
        name = resolved
    saved = torch.load(os.path.join(result_dir, name), map_location="cpu",
                       weights_only=True)
    model_state, opt_state = saved["model"], saved["optimizer"]
    if mesh is not None:
        from ihgnn_torch.parallel.tables import (shard_optimizer_state,
                                                 shard_params)
        model_state = shard_params(model_state, model.embeddings.table_mesh)
        opt_state = shard_optimizer_state(opt_state, optimizer, model)
    model.load_state_dict(model_state)
    optimizer.load_state_dict(opt_state)
    return int(saved["epoch_count"])
