"""Host-side policy around the train step's NaN guard (counterpart of
train/guards.py): count non-finite steps, save an emergency checkpoint on
the first of a run of them, and abort after `max_consecutive` in a row."""

from __future__ import annotations


class TrainGuard:
    max_consecutive = 20

    def __init__(self, ckpt_manager=None):
        self.ckpt = ckpt_manager
        self.consecutive_nonfinite = 0

    def observe(self, step: int, metrics: dict, train_state=None) -> bool:
        """Feed one step's metrics; True when training should abort."""
        if float(metrics.get("skipped_nonfinite", 0.0)) > 0:
            if (self.consecutive_nonfinite == 0
                    and self.ckpt is not None and train_state is not None):
                self.ckpt.save(step, train_state, metrics={"emergency": 1.0})
            self.consecutive_nonfinite += 1
        else:
            self.consecutive_nonfinite = 0
        return self.consecutive_nonfinite >= self.max_consecutive
