"""Coarse-only evaluation CLI of the port:

    python -m text2loc_tpu_torch.evaluation.coarse --synthetic --device cpu
"""

from text2loc_tpu_torch.evaluation.cli import main_coarse

if __name__ == "__main__":
    main_coarse()
