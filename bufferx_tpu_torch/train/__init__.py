"""Two-stage training (Desc, then Pose): losses, forward passes, the
guarded optimizer step, the trainer and the collapse guard."""
