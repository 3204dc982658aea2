"""Patience-based early stopping (reference EarlyStopping,
train_advanced.py:208-235: patience 10, min_delta 1e-3, max-mode on
val F1; the port's copy of the JAX package's ``train/early_stop.py``).
Pure-Python controller — it gates the host epoch loop, not the step."""

from __future__ import annotations


class EarlyStopping:
    def __init__(self, patience: int = 10, min_delta: float = 1e-3,
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.counter = 0
        self.best_score = None
        self.should_stop = False

    def update(self, score: float) -> bool:
        """Feed a new validation score; returns True when training should
        stop."""
        if self.best_score is None:
            self.best_score = score
        else:
            improved = (
                score > self.best_score + self.min_delta
                if self.mode == "max"
                else score < self.best_score - self.min_delta
            )
            if improved:
                self.best_score = score
                self.counter = 0
            else:
                self.counter += 1
                if self.counter >= self.patience:
                    self.should_stop = True
        return self.should_stop

    # reference-compatible call style
    __call__ = update
