"""nnuzoo_tpu_torch: the PyTorch / CUDA port of ``nnuzoo_tpu`` for NVIDIA Hopper.

The layout mirrors ``nnuzoo_tpu``: ``ops/`` (the selective scan, with its
hand-written CUDA kernels, forward and backward, in ``csrc/``), ``models/``,
``training/``, ``data/``, ``run/``, ``inference/``, ``plans/``,
``planning/``, ``preprocessing/``, ``imageio/``, ``evaluation/``,
``utilities/`` and ``cli/`` (``python -m nnuzoo_tpu_torch.cli
plan_and_preprocess|train|predict|predict_from_modelfolder|evaluate_folder|evaluate_simple``
and the three planning steps apart). ``convert.py`` turns the JAX package's
parameters into this package's ``state_dict`` and back. The package imports
neither JAX nor ``nnuzoo_tpu``.
"""

__version__ = "0.1.0"
