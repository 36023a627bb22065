"""Training: the train steps of both stages and both trainers with their
CLIs (coarse.py, fine.py)."""
