"""Host-side utilities of the trainers: metric logging, stage timing and
checkpoints."""
