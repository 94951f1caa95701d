"""Evaluation and checkpoint tools above the entry points: the port's
counterparts of the JAX package's ``scripts/``, each run as ``python -m
dicttts_tpu_torch.tools.<name>`` with its script's name and command line."""
