"""Training: the train steps of both stages and the coarse trainer."""
