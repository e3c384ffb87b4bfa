"""Training summaries (``frcnn_tpu/utils/summary.py``): scalars always go
to a JSONL file; TensorBoard event files are written too when the
``tensorboard`` package can be imported.  The TensorBoard writer is made at
the first record, so a run that records nothing never imports it."""

from __future__ import annotations

import json
import os
from typing import Any


class SummaryWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")
        self._tb = None
        self._tb_tried = False

    def _board(self):
        """torch's TensorBoard writer, or None where tensorboard is absent."""
        if not self._tb_tried:
            self._tb_tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter as BoardWriter
            except ImportError:
                return None
            self._tb = BoardWriter(self._log_dir)
        return self._tb

    def scalars(self, values: dict[str, Any], step: int):
        record = {"step": step, **{k: float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        board = self._board()
        if board is not None:
            for k, v in values.items():
                board.add_scalar(k, float(v), step)

    def image(self, tag: str, image, step: int):
        """image: (H, W, 3) uint8 RGB; TensorBoard only."""
        board = self._board()
        if board is not None:
            board.add_image(tag, image, step, dataformats="HWC")

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
