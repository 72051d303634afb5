"""Per-trainer hyperparameter table (the same table as
``nnuzoo_tpu/training/trainer_config.py``).

The reference expresses these as 19 trainer subclasses; here it is one table keyed
by trainer name (SURVEY.md §7.7). Values extracted from the reference trainers:

- base `nnUNetTrainer` (`nnUNetTrainer.py:179-184,571-575`): SGD nesterov momentum
  0.99, lr 1e-2, wd 3e-5, PolyLR, 1000 epochs, multi-scale deep supervision.
- model-zoo trainers (e.g. `nnUNetTrainerM2Net.py:19-71`): AdamW lr 1e-4 wd 5e-2
  eps 1e-5, CosineAnnealing eta_min 1e-6, 250 epochs, per-model DS scales.
- LightMUNet/LightSS2DMambaUNet (`nnUNetTrainerLightMUNet.py:25-124`): Adam wd
  1e-5 eps 1e-5, PolyLR.
"""

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class TrainerConfig:
    num_epochs: int = 1000
    initial_lr: float = 1e-2
    weight_decay: float = 3e-5
    optimizer: str = "sgd"         # sgd | adamw | adam
    momentum: float = 0.99
    nesterov: bool = True
    adam_eps: float = 1e-8
    scheduler: str = "poly"        # poly | cosine
    cosine_eta_min: float = 1e-6
    enable_deep_supervision: bool = True
    # DS target scales: 'arch' = from plans strides (multi-scale U-Net),
    # 'fullres' = all outputs at full resolution, 'x2net' = full,full,1/2,...
    ds_mode: str = "arch"
    num_ds_outputs: Optional[int] = None  # required for fullres/x2net modes
    num_iterations_per_epoch: int = 250
    num_val_iterations_per_epoch: int = 50
    oversample_foreground_percent: float = 0.33
    grad_clip_norm: float = 12.0
    save_every: int = 1
    data_fraction: float = 1.0     # nnUNetTrainer_XXPercent variants
    # mixed precision: bf16 forward/backward with fp32 master weights. This
    # package trains in fp32 so far: None and False mean fp32, True (or
    # NNUZOO_BF16=1) raises NotImplementedError in the Trainer.
    use_bf16: bool = None
    # size of the 'model' axis of a device mesh (1 = none). This package
    # trains on one device: anything above 1 raises in the Trainer.
    model_parallel: int = 1
    # FineTuneDecoderWarmUp semantics (reference
    # nnUNetTrainerFineTuneDecoderWarmUp.py:33-140): freeze the encoder for the
    # first N epochs (zero grads AND zero updates — no weight decay drift),
    # with a two-phase ContinuedPoly warmup schedule (scheduler =
    # "finetune_warmup"): encoder_warmup while frozen, decoder_warmup after.
    freeze_encoder_epochs: int = 0
    encoder_warmup_epochs: int = 0
    decoder_warmup_epochs: int = 0


_ZOO = TrainerConfig(num_epochs=250, initial_lr=1e-4, weight_decay=5e-2,
                     optimizer="adamw", adam_eps=1e-5, scheduler="cosine")
_LIGHT = TrainerConfig(num_epochs=250, initial_lr=1e-4, weight_decay=1e-5,
                       optimizer="adam", adam_eps=1e-5, scheduler="poly",
                       enable_deep_supervision=False)

TRAINER_CONFIGS = {
    "nnUNetTrainer": TrainerConfig(),
    "nnUNetTrainerResEncUNet": TrainerConfig(),
    # U2Net family: 7 full-res outputs
    "nnUNetTrainerU2Net": replace(_ZOO, ds_mode="fullres", num_ds_outputs=7),
    "nnUNetTrainerU2NetP": replace(_ZOO, ds_mode="fullres", num_ds_outputs=7),
    "nnUNetTrainerU2NetMulti": replace(_ZOO, ds_mode="fullres", num_ds_outputs=7),
    "nnUNetTrainerU2NetMultiP": replace(_ZOO, ds_mode="fullres", num_ds_outputs=7),
    # transformers
    "nnUNetTrainerUNETR": replace(_ZOO, weight_decay=0.01, scheduler="poly",
                                  enable_deep_supervision=False),
    "nnUNetTrainerSwinTransformerUnet": replace(_ZOO, enable_deep_supervision=False),
    "nnUNetTrainerSwUNETR": replace(_ZOO, enable_deep_supervision=False),
    # mamba models (DS heads at /1, /2, /4, /8)
    "nnUNetTrainerSwinUMamba": replace(_ZOO, ds_mode="halving", num_ds_outputs=4),
    "nnUNetTrainerSwinUMambaD": replace(_ZOO, ds_mode="halving", num_ds_outputs=4),
    "nnUNetTrainerLightMUNet": _LIGHT,
    "nnUNetTrainerLightSS2DMambaUNet": _LIGHT,
    "nnUNetTrainerSegMamba": replace(_ZOO, enable_deep_supervision=False),
    # X2Net hybrids: 7 outputs at (1, 1, 1/2, 1/4, 1/8, 1/16, 1/32)
    "nnUNetTrainerM2Net": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerM2NetP": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerSwT2Net": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerUNETR2Net": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerLM2Net": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerLM2NetP": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerLightMamba2Net": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerLightMamba2NetP": replace(_ZOO, ds_mode="x2net",
                                            num_ds_outputs=7),
    "nnUNetTrainerSSND2Net": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerSSND2NetP": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
    "nnUNetTrainerMambaND2Net": replace(_ZOO, ds_mode="x2net", num_ds_outputs=7),
}

# fine-tuning trainer (reference nnUNetTrainerFineTuneDecoderWarmUp.py:33-52):
# AdamW lr 1e-3 wd 5e-2 eps 1e-5, encoder frozen 50 epochs, 25-epoch encoder
# warmup then a fresh 50-epoch decoder warmup from the unfreeze point
TRAINER_CONFIGS["nnUNetTrainerFineTuneDecoderWarmUp"] = replace(
    _ZOO, ds_mode="x2net", num_ds_outputs=7, initial_lr=1e-3,
    scheduler="finetune_warmup", freeze_encoder_epochs=50,
    encoder_warmup_epochs=25, decoder_warmup_epochs=50)

DATA_FRACTIONS = {"_05Percent": 0.05, "_10Percent": 0.10, "_25Percent": 0.25,
              "_50Percent": 0.50, "_75Percent": 0.75}


def get_trainer_config(trainer_name: str) -> TrainerConfig:
    if trainer_name in TRAINER_CONFIGS:
        return TRAINER_CONFIGS[trainer_name]
    for suffix, frac in DATA_FRACTIONS.items():
        if trainer_name.endswith(suffix):
            base = get_trainer_config(trainer_name[: -len(suffix)])
            return replace(base, data_fraction=frac)
    raise RuntimeError(f"Unknown trainer {trainer_name!r}. "
                       f"Known: {sorted(TRAINER_CONFIGS)}")
