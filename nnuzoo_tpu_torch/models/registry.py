"""Model registry: trainer name -> network builder (port of
``nnuzoo_tpu/models/registry.py``, holding the names this package builds:
``nnUNetTrainer`` and ``nnUNetTrainerResEncUNet`` (the plan's own
architecture, PlainConvUNet or ResidualEncoderUNet), ``nnUNetTrainerU2Net``
and ``nnUNetTrainerU2NetP``, ``nnUNetTrainerM2NetP`` (M2NetP),
``nnUNetTrainerM2Net`` and ``nnUNetTrainerFineTuneDecoderWarmUp`` (M2Net),
the Mamba baselines ``nnUNetTrainerSwinUMamba``,
``nnUNetTrainerSwinUMambaD``, ``nnUNetTrainerLightMUNet``,
``nnUNetTrainerLightSS2DMambaUNet`` and ``nnUNetTrainerSegMamba``, the
Transformer baselines ``nnUNetTrainerUNETR``,
``nnUNetTrainerSwinTransformerUnet`` and ``nnUNetTrainerSwUNETR``, the
LM2Net family ``nnUNetTrainerLM2Net``, ``nnUNetTrainerLM2NetP``,
``nnUNetTrainerLightMamba2Net`` and ``nnUNetTrainerLightMamba2NetP``, the
N-d cross-scan hybrids ``nnUNetTrainerSSND2Net`` and
``nnUNetTrainerSSND2NetP``, and each of them with a ``_05Percent`` ..
``_75Percent`` suffix, which builds the base name's model).

    builder(plans_manager, dataset_json, configuration_manager,
            num_input_channels, deep_supervision=True, device="cuda",
            seed=0) -> nn.Module
"""

from typing import Callable, Dict

from .._device import resolve_device
from ..training.trainer_config import DATA_FRACTIONS
from .dynamic_unet import PlainConvUNet, ResidualEncoderUNet
from .layers import build_seeded

# the architecture names that plans hold, the original's dotted torch names too
ARCH_CLASSES = {
    "PlainConvUNet": PlainConvUNet,
    "ResidualEncoderUNet": ResidualEncoderUNet,
    "dynamic_network_architectures.architectures.unet.PlainConvUNet": PlainConvUNet,
    "dynamic_network_architectures.architectures.residual_unet.ResidualEncoderUNet":
        ResidualEncoderUNet,
}


def build_network_from_plans(plans_manager, dataset_json, configuration_manager,
                             num_input_channels, deep_supervision=True,
                             device="cuda", seed: int = 0):
    """The configuration's own architecture (``architecture.network_class_name``
    and ``arch_kwargs``), fp32, with weights drawn from ``seed`` (the JAX
    package's initialisers) on the CPU and moved to ``device``."""
    dev = resolve_device(device)
    arch_name = configuration_manager.network_arch_class_name
    if arch_name not in ARCH_CLASSES:
        raise RuntimeError(f"Unknown architecture {arch_name!r}. "
                           f"Known: {sorted(ARCH_CLASSES)}")
    label_manager = plans_manager.get_label_manager(dataset_json)
    arch_kwargs = dict(configuration_manager.network_arch_init_kwargs)
    return build_seeded(lambda: ARCH_CLASSES[arch_name](
        num_input_channels, arch_kwargs, label_manager.num_segmentation_heads,
        deep_supervision), dev, seed)


MODEL_BUILDERS: Dict[str, Callable] = {}


def register_model(trainer_names, builder: Callable) -> None:
    if isinstance(trainer_names, str):
        trainer_names = [trainer_names]
    for n in trainer_names:
        MODEL_BUILDERS[n] = builder


def get_model_builder(trainer_name: str) -> Callable:
    from . import (light_munet, lm2net, m2net, seg_mamba,  # noqa: F401
                   ssnd2net, swin_umamba, swt, u2net, unetr)  # (their names)
    if trainer_name in MODEL_BUILDERS:
        return MODEL_BUILDERS[trainer_name]
    # the data-fraction variants (nnUNetTrainer_25Percent ..) build the base model
    for suffix in DATA_FRACTIONS:
        if trainer_name.endswith(suffix):
            return get_model_builder(trainer_name[: -len(suffix)])
    raise RuntimeError(f"No model registered for trainer {trainer_name!r} in "
                       f"nnuzoo_tpu_torch. Known: {sorted(MODEL_BUILDERS)}")


register_model(["nnUNetTrainer", "nnUNetTrainerResEncUNet"],
               build_network_from_plans)
