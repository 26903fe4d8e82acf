"""Checkpoints on disk: atomic publish, bounded retention, asynchronous
writes and restore into a target structure (the reference's format)."""
from .store import (AsyncCheckpointer, latest_step, load_meta,
                    restore_checkpoint, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_meta", "AsyncCheckpointer"]
