"""The port's ``Trainer`` of ``nnUNetTrainerSwinUMamba`` and
``nnUNetTrainerSwinUMambaD`` (AdamW, cosine, ``ds_mode="halving"``: four
outputs at /1, /2, /4, /8) against the JAX package's: one step in fp64 on
both sides from converted weights, as ``test_torch_mamba_trainer.py`` holds
the other three Mamba baselines (its docstring states the setup and the
tolerances), with the encoder cut to one block a stage of widths 16-128 and
the decoder to widths 8-128 on both sides.
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from .test_torch_mamba_trainer import (_folders,  # noqa: E402,F401
                                       check_step_against_optax)


@pytest.mark.parametrize("name", ["nnUNetTrainerSwinUMamba",
                                  "nnUNetTrainerSwinUMambaD"])
def test_step_matches_the_optax_step_in_fp64(name, monkeypatch):
    check_step_against_optax(name, monkeypatch)
