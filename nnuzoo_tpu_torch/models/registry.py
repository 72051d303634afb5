"""Model registry: trainer name -> network builder (port of
``nnuzoo_tpu/models/registry.py``, holding the names this package builds:
``nnUNetTrainerM2NetP`` (M2NetP), ``nnUNetTrainerM2Net`` and
``nnUNetTrainerFineTuneDecoderWarmUp`` (M2Net)).

    builder(plans_manager, dataset_json, configuration_manager,
            num_input_channels, deep_supervision=True, device="cuda",
            seed=0) -> nn.Module
"""

from typing import Callable, Dict

MODEL_BUILDERS: Dict[str, Callable] = {}


def register_model(trainer_names, builder: Callable) -> None:
    if isinstance(trainer_names, str):
        trainer_names = [trainer_names]
    for n in trainer_names:
        MODEL_BUILDERS[n] = builder


def get_model_builder(trainer_name: str) -> Callable:
    from . import m2net  # noqa: F401  (registers its trainer names)
    if trainer_name in MODEL_BUILDERS:
        return MODEL_BUILDERS[trainer_name]
    raise RuntimeError(f"No model registered for trainer {trainer_name!r} in "
                       f"nnuzoo_tpu_torch. Known: {sorted(MODEL_BUILDERS)}")
