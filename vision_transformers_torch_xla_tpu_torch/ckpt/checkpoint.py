"""Checkpoints: save, rotate and resume the train state.

Counterpart of vision_transformers_torch_xla_tpu/ckpt/checkpoint.py
(`CheckpointManager`, `auto_resume`; :20-124), with the semantics of the
Orbax manager as the JAX package configures it:

- a save at an epoch at or below the newest saved one is refused
  (Orbax `should_save`);
- otherwise an epoch is saved when none is saved yet (Orbax's initial
  save) or when it is a multiple of `save_interval_epochs`;
- after a save, only the newest `max_to_keep` epochs stay (None keeps all);
- `restore` with no epoch takes the newest.

Layout: `<directory>/<epoch>/state.pt` (`TrainState.state_dict()` through
`torch.save`) and `<directory>/<epoch>/metadata.json`. The state is copied
to the host before `save` returns, so a step that then updates the live
tensors in place cannot reach the checkpoint; the files are written under
`<directory>/.tmp-<epoch>` and renamed, so an interrupted save never
becomes the newest epoch. Saves are synchronous: `wait` and `close` have
nothing to finish. A checkpoint written on the card restores on the CPU
and the other way round: `restore` copies into the template's tensors, on
their device, and `restore_raw` gives CPU tensors.

On a mesh a checkpoint is still one global state in this format, with
timm's whole tensors: rank 0 decides whether to save, every rank of the
mesh gathers the FSDP shards and the model axis's parts (collectives over
the mesh's groups; `group` holds the mesh's ranks, whose first is rank 0),
rank 0 writes and rotates, and a barrier over the mesh ends the save.
Every rank restores the whole file and copies its rows into its parts
(train/state.py), so a checkpoint crosses between a sharded or split run
and a one-process one in both directions.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from vision_transformers_torch_xla_tpu_torch.parallel.sharding import full

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def _to_host(x, splits, key: str = ""):
    """Whole host copies of a state dict's tensors; a tensor's `key` (its
    parameter name) picks its model-axis split."""
    if isinstance(x, torch.Tensor):
        return full(x.detach(), splits.get(key)).to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v, splits, k) for k, v in x.items()}
    return x


def _as_dict(state: Any) -> Dict[str, Any]:
    return state.state_dict() if hasattr(state, "state_dict") else state


class CheckpointManager:
    """Save / rotate / resume with the JAX manager's semantics."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_epochs: int = 1, group=None):
        """`group`: the ranks that save together (the mesh's; None is the
        default group when there is one)."""
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_epochs = save_interval_epochs
        self.group = group
        os.makedirs(directory, exist_ok=True)

    def all_epochs(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, STATE_FILE)))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def should_save(self, epoch: int) -> bool:
        latest = self.latest_epoch()
        if latest is None:
            return True
        return epoch > latest and epoch % self.save_interval_epochs == 0

    def save(self, epoch: int, state: Any,
             metadata: Optional[dict] = None) -> bool:
        """Save `state` (a TrainState or its dict) as `epoch` if the policy
        takes it, then rotate; returns whether it saved."""
        together = dist.is_initialized() and \
            dist.get_world_size(self.group) > 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        decided = [self.should_save(epoch) if rank == 0 else None]
        if together:
            dist.broadcast_object_list(decided, src=0, group=self.group)
        if not decided[0]:
            return False
        host = _to_host(_as_dict(state), getattr(state, "splits", {}))
        if rank == 0:
            self._write(epoch, host, metadata)
        if together:
            dist.barrier(group=self.group)
        return True

    def _write(self, epoch: int, host: Dict[str, Any],
               metadata: Optional[dict]) -> None:
        tmp = os.path.join(self.directory, f".tmp-{epoch}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_FILE))
        if metadata is not None:
            with open(os.path.join(tmp, METADATA_FILE), "w") as f:
                json.dump(metadata, f)
        os.replace(tmp, os.path.join(self.directory, str(epoch)))
        if self.max_to_keep is not None:
            for old in self.all_epochs()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def _resolve(self, epoch: Optional[int]) -> Optional[int]:
        return epoch if epoch is not None else self.latest_epoch()

    def restore_raw(self, epoch: Optional[int] = None,
                    map_location: Any = "cpu") -> Optional[Dict[str, Any]]:
        """The saved dict of `epoch` (the newest if None), its tensors on
        `map_location`; None when nothing is saved."""
        epoch = self._resolve(epoch)
        if epoch is None:
            return None
        path = os.path.join(self.directory, str(epoch), STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint of epoch {epoch} under "
                                    f"{self.directory!r}")
        return torch.load(path, map_location=map_location, weights_only=True)

    def metadata(self, epoch: Optional[int] = None) -> Optional[dict]:
        epoch = self._resolve(epoch)
        path = os.path.join(self.directory, str(epoch), METADATA_FILE)
        if epoch is None or not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, state_template: Any, epoch: Optional[int] = None
                ) -> Tuple[Any, Optional[dict]]:
        """Copy `epoch` (the newest if None) into the template's live
        tensors; returns (template, metadata), or (None, None) when nothing
        is saved."""
        epoch = self._resolve(epoch)
        raw = self.restore_raw(epoch)
        if raw is None:
            return None, None
        return state_template.load_state_dict(raw), self.metadata(epoch)

    def wait(self):
        """Saves are synchronous; nothing is in flight."""

    def close(self):
        """Nothing is held open."""


def auto_resume(manager: CheckpointManager, state_template: Any):
    """Resume from the newest checkpoint if one exists: (state, the epoch
    to start at), or (None, 0)."""
    epoch = manager.latest_epoch()
    if epoch is None:
        return None, 0
    state, meta = manager.restore(state_template, epoch)
    start_epoch = (meta or {}).get("epoch", epoch) + 1
    log.info("auto-resumed from epoch %d", epoch)
    return state, start_epoch
