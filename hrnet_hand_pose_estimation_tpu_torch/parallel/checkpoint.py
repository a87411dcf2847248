"""Checkpoints, AUTO_RESUME and warm starts.

Port of the JAX package's ``parallel/checkpoint.py`` (orbax there; here
``torch.save``, as the card's machine has no orbax).  The payload is the
same: {epoch, step, parameters, BN statistics, optimizer state, best_loss,
train/valid global steps}, so a resume continues the same trajectory
bit for bit.  ``best.pt`` is the best-model snapshot (reference
model_best.pth.tar), parameters and BN statistics only.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")
_STAT_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """One ``ckpt_<epoch>.pt`` per saved epoch, the newest ``max_to_keep``
    kept, and ``best.pt``."""

    def __init__(self, directory: str, max_to_keep: int = 3, create: bool = True):
        """``create`` False (a data-parallel rank other than 0, which reads
        but never writes) leaves the directory as it is."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(epoch)}.pt")

    def epochs(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m[1]) for m in map(_CKPT.match, os.listdir(self.directory)) if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state, extra: Optional[Dict] = None) -> None:
        """``state``: a train state, or its ``state_dict()`` payload (made on
        every rank of a model group, which gathers the shards)."""
        meta = {"epoch": int(epoch), "best_loss": float("inf"), "train_global_steps": 0,
                "valid_global_steps": 0}
        meta.update(extra or {})
        _atomic_save({"state": _payload(state), "meta": meta}, self._path(epoch))
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state, epoch: Optional[int] = None) -> Optional[Dict]:
        """Load checkpoint ``epoch`` (the newest by default) into ``state``
        in place; returns {"state": state, "meta": ...} or None if there is
        none."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return None
        payload = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        state.load_state_dict(payload["state"])
        return {"state": state, "meta": payload["meta"]}

    def save_best(self, state) -> None:
        sd = _payload(state)
        _atomic_save({"params": sd["params"], "batch_stats": sd["batch_stats"]},
                     os.path.join(self.directory, "best.pt"))


def _payload(state) -> Dict:
    return state if isinstance(state, dict) else state.state_dict()


def merge_pretrained(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], list, list]:
    """Copy every ``src`` tensor whose name exists in ``dst`` with the same
    shape (cast to ``dst``'s dtype); leave everything else as it is.

    The reference's partial warm-start contract (pose_hrnet.py init_weights:
    a filtered state_dict loaded with ``strict=False``): pretrained trunks
    never cover the task head, and a shape-divergent tensor (another
    NUM_JOINTS) must not clobber the initialisation.  The port's state
    dicts are flat, so names are module paths.  Returns ``(merged,
    copied_names, skipped_names)``.
    """
    merged = dict(dst)
    copied, skipped = [], []
    for name, val in src.items():
        if name in dst and tuple(val.shape) == tuple(dst[name].shape):
            merged[name] = val.to(dst[name].dtype)
            copied.append(name)
        else:
            skipped.append(name)
    return merged, copied, skipped


def split_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A flat model state_dict -> {"params", "batch_stats"} by name."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"params": {}, "batch_stats": {}}
    for name, val in state.items():
        out["batch_stats" if name.endswith(_STAT_SUFFIXES) else "params"][name] = val
    return out


def join_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of ``split_state_dict``: {"params", "batch_stats"} (as
    ``load_pretrained`` returns) -> one flat state_dict; a flat state_dict
    passes through."""
    if "params" in variables and isinstance(variables["params"], Mapping):
        return {**variables["params"], **variables.get("batch_stats", {})}
    return dict(variables)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth(.tar)`` -> its flat state_dict (under
    ``state_dict`` if the file nests it), without a ``module.`` prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    state = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state.items()}


def load_pretrained(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Warm-start weights as {"params", "batch_stats"}: a port snapshot
    (``best.pt``), a port checkpoint (``ckpt_<epoch>.pt``) or a reference
    ``.pth(.tar)`` state_dict (reference MODEL.HRNET_PRETRAINED,
    tools/train.py:173-182)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "params" in obj:
        return {"params": obj["params"], "batch_stats": obj.get("batch_stats", {})}
    if isinstance(obj, dict) and "state" in obj and "meta" in obj:
        return {"params": obj["state"]["params"], "batch_stats": obj["state"]["batch_stats"]}
    return split_state_dict(load_torch_checkpoint(path))
