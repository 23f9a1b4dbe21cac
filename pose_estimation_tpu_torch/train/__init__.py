"""Training: Ranger, the train state, the train step, checkpoints, the
trainer."""
