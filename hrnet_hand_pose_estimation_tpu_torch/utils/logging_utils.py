"""Run logging: per-run log files and TensorBoard scalars.

Port of the JAX package's ``utils/logging_utils.py:18-65`` (reference
lib/utils/utils.py:22-68 and the tensorboardX writer of
lib/core/function.py:124-157).  Run layout: ``OUTPUT_DIR/<dataset>/<EXP_NAME>/``
for logs and checkpoints, ``tb/`` below it for event files.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional


def create_logger(cfg, phase: str = "train"):
    """Returns (logger, final_output_dir, tb_log_dir)."""
    root = Path(cfg.OUTPUT_DIR or "output")
    dataset = "_".join(list(cfg.DATASET.DATASET)) or "run"
    exp = cfg.EXP_NAME or "exp"
    final_output_dir = root / dataset / exp
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = final_output_dir / f"{exp}_{time_str}_{phase}.log"

    logger = logging.getLogger(exp)
    logger.setLevel(logging.INFO)
    logger.propagate = False  # avoid duplicate lines via the root logger
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)

    tb_dir = final_output_dir / "tb"
    tb_dir.mkdir(exist_ok=True)
    return logger, str(final_output_dir), str(tb_dir)


class ScalarWriter:
    """TensorBoard scalar writer; a no-op when tensorboardX is not installed."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
