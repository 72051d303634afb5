"""The training runtime (port of ``nnuzoo_tpu/training/trainer.py``).

One ``Trainer`` class and the ``TRAINER_CONFIGS`` table. Lifecycle as in the
JAX package: fold splitting (``splits_final.json``, seeded 5-fold), 250 train
and 50 validation iterations per epoch, best checkpoint by the EMA of the
pseudo dice, ``checkpoint_latest`` every epoch, poly / cosine schedules,
gradient clipping at 12.

Execution model here: eager PyTorch on one device. A step is device-side
augmentation -> channels-last forward -> deep-supervision loss -> backward ->
clip -> optimizer update; the host side is a ``PatchSampler`` thread behind a
``DevicePrefetcher``. fp32 throughout. Randomness comes from explicit
generators made from ``seed``: the weights, the DropPath masks and the
augmentation each have their own.

The final validation (``perform_actual_validation``) predicts the fold's
validation cases with the port's ``Predictor``, writes them through the plans'
writer and scores them against ``gt_segmentations``. A cascade's first stage
(a configuration with a next stage, ``3d_lowres``) also writes each case's
prediction at the next stage's shape to ``predicted_next_stage/<next
stage>/``; the cascaded stage (``3d_cascade_fullres``) trains and validates
with those as one-hot input channels. A ``target_type: "translation"``
dataset trains on the deep-supervision MSE and is scored with the
regression metrics.

The fine-tuning trainer (``freeze_encoder_epochs``) freezes the encoder as
the JAX package does: while frozen, the encoder's gradients are zero before
the clip, the optimizer steps on every parameter (so the frozen ones' moments
decay and their step counts advance, as optax's shared count does), and the
frozen parameters are then put back as they were.

Not ported yet, each raising ``NotImplementedError``: the SSL (MAE) target,
device meshes and multi-process batches, and bf16. ``load_checkpoint`` also
continues a fold that the JAX package trained with AdamW or SGD.
"""

import os
import re
import time
from dataclasses import asdict, replace
from datetime import datetime
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..configuration import ANISO_THRESHOLD
from ..convert import adamw_state_from_optax, convert_params, \
    sgd_state_from_optax
from ..data.augment import AugmentConfig, augment_train_batch, get_patch_size, \
    prepare_val_batch
from ..data.dataset import DatasetNumpy, infer_dataset_class, unpack_dataset
from ..data.loader import DevicePrefetcher
from ..data.patch_sampler import PatchSampler
from ..models.registry import get_model_builder
from ..plans.label_handling import determine_num_input_channels
from ..plans.plans_handler import PlansManager
from ..utilities.crossval import generate_crossval_split
from ..utilities.file_path_utilities import get_output_folder
from ..utilities.flax_msgpack import msgpack_restore
from ..utilities.io import (isfile, join, load_json, load_pickle, maybe_mkdir,
                            save_json, save_pickle)
from .logger import TrainingLogger
from .losses import (deep_supervision_loss, dice_bce_loss, dice_ce_loss,
                     get_deep_supervision_weights, hard_dice_stats)
from .schedulers import (cosine_annealing, finetune_double_warmup_lr, per_step,
                         poly_lr)
from .trainer_config import TrainerConfig, get_trainer_config


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm where their global L2 norm
    exceeds ``max_norm`` (the rule of ``optax.clip_by_global_norm``; torch's
    ``clip_grad_norm_`` divides by norm + 1e-6 instead). Returns the norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Trainer:
    def __init__(self, plans: dict, configuration: str, fold, dataset_json: dict,
                 unpack_dataset_flag: bool = True, device="cuda",
                 num_epochs: Optional[int] = None,
                 trainer_name: str = "nnUNetTrainer", seed: Optional[int] = None):
        self.device = resolve_device(device)
        self.trainer_name = trainer_name
        self.config: TrainerConfig = get_trainer_config(trainer_name)
        if num_epochs is not None:
            self.config = replace(self.config, num_epochs=num_epochs)

        self.plans_manager = PlansManager(plans)
        self.configuration_manager = self.plans_manager.get_configuration(configuration)
        self.configuration_name = configuration
        self.fold = fold
        self.dataset_json = dataset_json
        self.label_manager = self.plans_manager.get_label_manager(dataset_json)
        self.target_type = dataset_json.get("target_type", "segmentation")
        self.unpack_dataset_flag = unpack_dataset_flag
        self._check_ported()

        self.preprocessed_dataset_folder_base = join(
            os.environ.get("nnUNet_preprocessed", ""), self.plans_manager.dataset_name)
        self.preprocessed_dataset_folder = join(
            self.preprocessed_dataset_folder_base,
            self.configuration_manager.data_identifier)
        self.output_folder_base = get_output_folder(
            self.plans_manager.dataset_name, trainer_name,
            self.plans_manager.plans_name, configuration)
        self.output_folder = join(self.output_folder_base, f"fold_{fold}")

        self.num_input_channels = determine_num_input_channels(
            self.plans_manager, self.configuration_manager, dataset_json)

        self._dataset_class = None
        self.current_epoch = 0
        self._best_ema = None
        self.logger = TrainingLogger()
        self.inference_allowed_mirroring_axes = None
        self.model = None
        self.optimizer = None
        self.step = 0                   # optimizer steps taken
        self.seed = int.from_bytes(os.urandom(4), "little") if seed is None \
            else int(seed)
        self._seeded = seed is not None
        self._aug_generator = torch.Generator(device=self.device)
        self._aug_generator.manual_seed(self.seed + 1)
        self.was_initialized = False
        self.is_rank0 = True            # one process

        maybe_mkdir(self.output_folder)
        ts = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        self.log_file = join(self.output_folder, f"training_log_{ts}.txt")

        # the constructor's arguments, so that a checkpoint describes itself
        self.my_init_kwargs = {"plans": plans, "configuration": configuration,
                               "fold": fold, "dataset_json": dataset_json,
                               "trainer_name": trainer_name}

    def _check_ported(self):
        cfg = self.config
        if self.target_type not in ("segmentation", "translation"):
            raise NotImplementedError(
                f"target_type {self.target_type!r}: the SSL (MAE) target is not "
                "in nnuzoo_tpu_torch yet")
        if int(os.environ.get("NNUZOO_MODEL_PARALLEL", cfg.model_parallel)) > 1:
            raise NotImplementedError(
                "device meshes are not in nnuzoo_tpu_torch yet: it trains on one "
                "device")
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "multi-process batches are not in nnuzoo_tpu_torch yet")
        env_bf16 = os.environ.get("NNUZOO_BF16", "")
        if env_bf16 == "1" or (env_bf16 != "0" and cfg.use_bf16):
            raise NotImplementedError(
                "bf16 training is not in nnuzoo_tpu_torch yet: it trains in fp32")

    @property
    def dataset_class(self):
        """Storage backend inferred from the preprocessed folder's file endings."""
        if self._dataset_class is None:
            self._dataset_class = infer_dataset_class(
                self.preprocessed_dataset_folder)
        return self._dataset_class

    # ----------------------------------------------------------------- logging
    def print_to_log_file(self, *args, also_print_to_console=True,
                          add_timestamp=True):
        if add_timestamp:
            args = (f"{datetime.now()}:", *args)
        try:
            with open(self.log_file, "a+") as f:
                f.write(" ".join(str(a) for a in args) + "\n")
        except IOError:
            pass
        if also_print_to_console:
            print(*args)

    # ----------------------------------------------------------------- DS scales
    def _get_deep_supervision_scales(self):
        cfg = self.config
        if not cfg.enable_deep_supervision:
            return None
        dim = len(self.configuration_manager.patch_size)
        if cfg.ds_mode == "arch":
            strides = self.configuration_manager.pool_op_kernel_sizes
            cum = np.cumprod(np.vstack(strides), axis=0)
            scales = list(list(1 / i) for i in cum)[:-1]  # drop the deepest
            return tuple(tuple(float(x) for x in s) for s in scales)
        if cfg.ds_mode == "fullres":
            return tuple((1.0,) * dim for _ in range(cfg.num_ds_outputs))
        if cfg.ds_mode == "halving":
            probed = self._probe_output_scales()
            if probed is not None:
                return probed
            return tuple(tuple(1.0 / (2 ** i) for _ in range(dim))
                         for i in range(cfg.num_ds_outputs))
        if cfg.ds_mode == "x2net":
            # nominally d0, d1 at full resolution and then halving, but at small
            # patch sizes the merges clamp or truncate, so the true scales are
            # read off the model's output shapes
            probed = self._probe_output_scales()
            if probed is not None:
                return probed
            scales = [(1.0,) * dim, (1.0,) * dim]
            for i in range(cfg.num_ds_outputs - 2):
                scales.append(tuple(1.0 / (2 ** (i + 1)) for _ in range(dim)))
            return tuple(scales)
        raise RuntimeError(f"unknown ds_mode {cfg.ds_mode}")

    def _probe_output_scales(self):
        """Per-output spatial scales from the model's output shapes at the
        configured patch size: one forward at batch 1 without gradients."""
        if self.model is None:
            return None
        patch = tuple(int(i) for i in self.configuration_manager.patch_size)
        x = torch.zeros(1, *patch, self.num_input_channels, device=self.device)
        was_training = self.model.training
        self.model.eval()
        with torch.no_grad():
            outs = self.model(x)
        self.model.train(was_training)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        return tuple(tuple(o.shape[1 + i] / patch[i] for i in range(len(patch)))
                     for o in outs)

    # ----------------------------------------------------------------- aug setup
    def configure_rotation_dummyDA_mirroring_and_initial_patch_size(self):
        patch_size = self.configuration_manager.patch_size
        dim = len(patch_size)
        if dim == 2:
            do_dummy_2d = False
            rotation = (np.pi * 15 / 180) if max(patch_size) / min(patch_size) > 1.5 \
                else np.pi
            mirror_axes = (0, 1)
        elif dim == 3:
            do_dummy_2d = (max(patch_size) / patch_size[0]) > ANISO_THRESHOLD
            rotation = np.pi if do_dummy_2d else (np.pi * 30 / 180)
            mirror_axes = (0, 1, 2)
        else:
            raise RuntimeError(f"unsupported dim {dim}")

        initial_patch_size = get_patch_size(
            patch_size[-dim:], (-rotation, rotation), (-rotation, rotation),
            (-rotation, rotation), (0.85, 1.25))
        if do_dummy_2d:
            initial_patch_size[0] = patch_size[0]
        self.inference_allowed_mirroring_axes = mirror_axes
        return rotation, do_dummy_2d, tuple(int(i) for i in initial_patch_size), \
            mirror_axes

    def _make_augment_config(self) -> Tuple[AugmentConfig, AugmentConfig]:
        rotation, do_dummy_2d, initial_patch_size, mirror_axes = \
            self.configure_rotation_dummyDA_mirroring_and_initial_patch_size()
        ds_scales = self._get_deep_supervision_scales()
        regions = None
        if self.label_manager.has_regions:
            regions = [tuple(r) if isinstance(r, (list, tuple)) else (r,)
                       for r in self.label_manager.foreground_regions]
            if self.label_manager.has_ignore_label:
                regions = regions + [(self.label_manager.ignore_label,)]
            regions = tuple(regions)
        patch_size = tuple(int(i) for i in self.configuration_manager.patch_size)
        is_cascaded = self.configuration_manager.previous_stage_name is not None
        common = dict(
            patch_size=patch_size,
            mirror_axes=tuple(mirror_axes),
            do_dummy_2d=do_dummy_2d,
            use_mask_for_norm=tuple(bool(b) for b in
                                    self.configuration_manager.use_mask_for_norm),
            deep_supervision_scales=ds_scales,
            regions=regions,
            rotation=float(rotation),
            is_cascaded=is_cascaded,
            foreground_labels=tuple(int(label) for label in
                                    self.label_manager.foreground_labels)
            if is_cascaded else (),
            target_type=self.target_type,
        )
        train_cfg = AugmentConfig(initial_patch_size=initial_patch_size, **common)
        val_cfg = AugmentConfig(initial_patch_size=patch_size, **common)
        return train_cfg, val_cfg

    # ----------------------------------------------------------------- init
    def _build_optimizer(self):
        """The optimizer and the per-step learning-rate schedule. The clip at
        ``grad_clip_norm`` is applied in :meth:`train_step` before the update;
        the rate is set from the schedule there too."""
        cfg = self.config
        if cfg.scheduler == "poly":
            epoch_sched = poly_lr(cfg.initial_lr, cfg.num_epochs)
        elif cfg.scheduler == "cosine":
            epoch_sched = cosine_annealing(cfg.initial_lr, cfg.num_epochs,
                                           cfg.cosine_eta_min)
        elif cfg.scheduler == "finetune_warmup":
            epoch_sched = finetune_double_warmup_lr(
                cfg.initial_lr, cfg.num_epochs, cfg.freeze_encoder_epochs,
                cfg.encoder_warmup_epochs, cfg.decoder_warmup_epochs)
        else:
            raise RuntimeError(f"unknown scheduler {cfg.scheduler}")
        self._epoch_schedule = epoch_sched
        self._step_schedule = per_step(epoch_sched, cfg.num_iterations_per_epoch)

        params = list(self.model.parameters())
        lr = self._step_schedule(0)
        if cfg.optimizer == "sgd":
            # L2 decay added to the gradient, then momentum (nesterov)
            return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                                   nesterov=cfg.nesterov,
                                   weight_decay=cfg.weight_decay)
        if cfg.optimizer in ("adamw", "adam"):
            # "adam" is decoupled AdamW too, as in the JAX package
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                     eps=cfg.adam_eps,
                                     weight_decay=cfg.weight_decay)
        raise RuntimeError(f"unknown optimizer {cfg.optimizer}")

    def initialize(self):
        if self.was_initialized:
            return
        builder = get_model_builder(self.trainer_name)
        self.enable_deep_supervision = self.config.enable_deep_supervision
        self.model = builder(self.plans_manager, self.dataset_json,
                             self.configuration_manager, self.num_input_channels,
                             self.config.enable_deep_supervision,
                             device=self.device, seed=self.seed)
        self.train_aug_cfg, self.val_aug_cfg = self._make_augment_config()
        self.optimizer = self._build_optimizer()
        frozen = set(self._encoder_freeze_mask(self.model)) \
            if self.config.freeze_encoder_epochs else set()
        self._frozen = [p for n, p in self.model.named_parameters() if n in frozen]
        self.step = 0
        self.global_batch_size = self.local_batch_size = \
            self.configuration_manager.batch_size
        self.local_oversample = self.config.oversample_foreground_percent
        n_params = sum(p.numel() for p in self.model.parameters())
        self.print_to_log_file(
            f"Initialized {self.trainer_name} ({type(self.model).__name__}), "
            f"{n_params / 1e6:.2f}M params, device={self.device}")
        self.was_initialized = True

    # ----------------------------------------------------------------- steps
    def _compute_loss(self, outputs: List[torch.Tensor], targets: List[torch.Tensor]):
        """outputs channels-last, targets (B, S, *spatial)."""
        batch_dice = self.configuration_manager.batch_dice
        ignore_label = self.label_manager.ignore_label

        def to_cf(o):  # channels-last -> channels-first for the loss functions
            return o.movedim(-1, 1)

        if self.target_type == "translation":
            fn = lambda o, t: torch.mean((to_cf(o) - t.float()) ** 2)
        elif self.label_manager.has_regions:
            fn = lambda o, t: dice_bce_loss(
                to_cf(o), t, batch_dice=batch_dice,
                use_ignore_label=ignore_label is not None)
        else:
            fn = lambda o, t: dice_ce_loss(
                to_cf(o), t, batch_dice=batch_dice, ignore_label=ignore_label)

        if not self.config.enable_deep_supervision:
            return fn(outputs[0], targets[0])
        weights = get_deep_supervision_weights(len(outputs))
        return deep_supervision_loss(fn, outputs, targets[:len(outputs)], weights)

    def loss_and_grads(self, data_aug: torch.Tensor, targets: List[torch.Tensor]):
        """Forward in training mode and backward: the loss, with the gradients
        left in the parameters' ``.grad``. data_aug is (B, C, *patch)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(data_aug.movedim(1, -1).contiguous())
        loss = self._compute_loss([o.float() for o in outputs], targets)
        loss.backward()
        return loss.detach()

    @staticmethod
    def _encoder_freeze_mask(model: torch.nn.Module) -> List[str]:
        """The names of the parameters that the fine-tuning trainer freezes:
        those with any name component ``stage1``..``stage6`` or
        ``patch_merging1``..``patch_merging4``, as the JAX package's mask
        has it (it also takes the VSS layers of every MU's decoder, which
        are named ``stage1``..; the original freezes only the top-level
        stages)."""
        pattern = re.compile(r"^(stage[1-6]|patch_merging[1-4])$")
        return [name for name, _ in model.named_parameters()
                if any(pattern.match(part) for part in name.split("."))]

    def apply_gradients(self) -> None:
        """Clip the gradients by their global norm, set this step's learning
        rate and update. A parameter that the loss does not reach (the
        deepest deep-supervision head, whose weight is 0) gets a zero
        gradient, not None: torch's optimizers would skip it, where optax
        decays it, moves its momentum and counts its step. While the
        encoder is frozen (the first ``freeze_encoder_epochs`` epochs), its
        gradients are zero before the clip, the optimizer steps on every
        parameter, and the frozen parameters are put back as they were,
        weight decay undone."""
        frozen = self._frozen if self.step < (self.config.freeze_encoder_epochs *
                                              self.config.num_iterations_per_epoch) \
            else []
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for p in frozen:
            p.grad.zero_()
        kept = [p.detach().clone() for p in frozen]
        grads = [p.grad for p in self.model.parameters()]
        clip_by_global_norm_(grads, self.config.grad_clip_norm)
        lr = self._step_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if frozen:
            with torch.no_grad():
                torch._foreach_copy_(frozen, kept)
        self.step += 1

    def train_step(self, data: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """One step from a sampled batch on the device: data (B, C,
        *initial_patch), seg (B, S, *initial_patch). Returns the loss (a
        tensor on the device: nothing waits for it here)."""
        with torch.no_grad():
            data_aug, targets = augment_train_batch(
                self.train_aug_cfg, self._aug_generator, data, seg)
        loss = self.loss_and_grads(data_aug, targets)
        self.apply_gradients()
        return loss

    @torch.no_grad()
    def val_step(self, data: torch.Tensor, seg: torch.Tensor):
        """(loss, tp, fp, fn) of one validation batch; a translation target
        has no Dice and gives zeros for tp, fp and fn."""
        data_p, targets = prepare_val_batch(self.val_aug_cfg, data, seg)
        self.model.eval()
        outputs = [o.float() for o in self.model(data_p.movedim(1, -1).contiguous())]
        loss = self._compute_loss(outputs, targets)
        if self.target_type == "translation":
            zero = torch.zeros(1, device=loss.device)
            return loss, zero, zero, zero
        logits_cf = outputs[0].movedim(-1, 1)
        target0 = targets[0]
        lm = self.label_manager
        if lm.has_ignore_label:
            if not lm.has_regions:
                mask = (target0 != lm.ignore_label).float()
                target_d = torch.where(target0 == lm.ignore_label,
                                       torch.zeros_like(target0), target0)
            else:
                mask = 1.0 - target0[:, -1:]
                target_d = target0[:, :-1]
        else:
            mask = None
            target_d = target0
        tp, fp, fn = hard_dice_stats(
            logits_cf, target_d,
            num_classes=lm.num_segmentation_heads if not lm.has_regions
            else lm.num_segmentation_heads + 1,
            has_regions=lm.has_regions, ignore_label_mask=mask)
        return loss, tp, fp, fn

    # ----------------------------------------------------------------- split
    def do_split(self) -> Tuple[List[str], List[str]]:
        if self.fold == "all":
            keys = self.dataset_class.get_identifiers(
                self.preprocessed_dataset_folder)
            return sorted(keys), sorted(keys)
        splits_file = join(self.preprocessed_dataset_folder_base,
                           "splits_final.json")
        keys = sorted(self.dataset_class.get_identifiers(
            self.preprocessed_dataset_folder))
        if not isfile(splits_file):
            splits = generate_crossval_split(keys, seed=12345, n_splits=5)
            save_json(splits, splits_file)
        else:
            splits = load_json(splits_file)
        fold = int(self.fold)
        if fold >= len(splits):
            raise RuntimeError(f"fold {fold} requested but only {len(splits)} "
                               f"splits available")
        tr_keys = splits[fold]["train"]
        val_keys = splits[fold]["val"]
        if self.config.data_fraction < 1.0:
            rng = np.random.RandomState(12345)
            n = max(1, int(len(tr_keys) * self.config.data_fraction))
            tr_keys = list(rng.choice(tr_keys, n, replace=False))
        return tr_keys, val_keys

    # ----------------------------------------------------------------- data
    def _previous_stage_folder(self) -> Optional[str]:
        """Where the previous stage wrote its predictions for this
        configuration (``predicted_next_stage/<this configuration>``), or None
        for a configuration without a previous stage."""
        if self.configuration_manager.previous_stage_name is None:
            return None
        return join(self.preprocessed_dataset_folder_base, "predicted_next_stage",
                    self.configuration_name)

    def get_dataloaders(self):
        tr_keys, val_keys = self.do_split()
        prev = self._previous_stage_folder()
        ds_tr = self.dataset_class(self.preprocessed_dataset_folder, tr_keys,
                                   folder_with_segs_from_previous_stage=prev)
        ds_val = self.dataset_class(self.preprocessed_dataset_folder, val_keys,
                                    folder_with_segs_from_previous_stage=prev)
        dim = len(self.configuration_manager.patch_size)
        # a Trainer made with a seed samples the same patches on every run
        train_sampler = PatchSampler(
            ds_tr, self.local_batch_size,
            seed=self.seed + 2 if self._seeded else None,
            initial_patch_size=self.train_aug_cfg.initial_patch_size[-dim:],
            final_patch_size=tuple(self.configuration_manager.patch_size),
            label_manager=self.label_manager,
            oversample_foreground_percent=self.local_oversample,
            target_type=self.target_type)
        val_sampler = PatchSampler(
            ds_val, self.local_batch_size,
            seed=self.seed + 3 if self._seeded else None,
            initial_patch_size=self.configuration_manager.patch_size,
            final_patch_size=self.configuration_manager.patch_size,
            label_manager=self.label_manager,
            oversample_foreground_percent=self.local_oversample,
            target_type=self.target_type)
        self.dataloader_train = DevicePrefetcher(train_sampler, buffer_size=2,
                                                 device=self.device)
        self.dataloader_val = DevicePrefetcher(val_sampler, buffer_size=2,
                                               device=self.device)

    # ----------------------------------------------------------------- epochs
    def train_epoch(self) -> float:
        losses = []
        for _ in range(self.config.num_iterations_per_epoch):
            batch = next(self.dataloader_train)
            losses.append(self.train_step(batch["data"], batch["target"]))
        return float(torch.stack(losses).mean())

    def validation_epoch(self):
        losses, tps, fps, fns = [], [], [], []
        for _ in range(self.config.num_val_iterations_per_epoch):
            batch = next(self.dataloader_val)
            loss, tp, fp, fn = self.val_step(batch["data"], batch["target"])
            losses.append(loss)
            tps.append(tp)
            fps.append(fp)
            fns.append(fn)
        mean_loss = float(torch.stack(losses).mean())
        if self.target_type == "translation":
            # no Dice for a regression: -loss is what the EMA of the best
            # checkpoint follows
            return mean_loss, np.array([-mean_loss])
        tp, fp, fn = (torch.stack(x).sum(0).double().cpu().numpy()
                      for x in (tps, fps, fns))
        global_dc_per_class = 2 * tp / np.clip(2 * tp + fp + fn, 1e-8, None)
        return mean_loss, global_dc_per_class

    def _run_epoch(self):
        epoch = self.current_epoch
        t0 = time.time()
        self.logger.log("epoch_start_timestamps", t0, epoch)
        train_loss = self.train_epoch()
        val_loss, dice_per_class = self.validation_epoch()
        mean_fg_dice = float(np.nanmean(dice_per_class))

        self.logger.log("train_losses", train_loss, epoch)
        self.logger.log("val_losses", val_loss, epoch)
        self.logger.log("mean_fg_dice", mean_fg_dice, epoch)
        self.logger.log("dice_per_class_or_region",
                        [float(d) for d in dice_per_class], epoch)
        self.logger.log("lrs", float(self._epoch_schedule(epoch)), epoch)
        self.logger.log("epoch_end_timestamps", time.time(), epoch)
        self.print_to_log_file(
            f"Epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
            f"pseudo-dice {[round(float(d), 4) for d in dice_per_class]} "
            f"({time.time() - t0:.1f}s)")
        self.on_epoch_end()
        self.current_epoch += 1

    def run_training(self):
        self.on_train_start()
        profile_dir = os.environ.get("NNUZOO_PROFILE_DIR")
        try:
            while self.current_epoch < self.config.num_epochs:
                if profile_dir and self.current_epoch == 0:
                    # trace the first epoch (a Chrome trace under the folder)
                    from torch.profiler import ProfilerActivity, profile
                    activities = [ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        activities.append(ProfilerActivity.CUDA)
                    maybe_mkdir(profile_dir)
                    with profile(activities=activities) as prof:
                        self._run_epoch()
                    prof.export_chrome_trace(join(profile_dir, "epoch0_trace.json"))
                    self.print_to_log_file(f"Profile written to {profile_dir}")
                else:
                    self._run_epoch()
        except KeyboardInterrupt:
            self.save_checkpoint(join(self.output_folder, "checkpoint_latest.pth"))
            raise
        self.on_train_end()

    def on_train_start(self):
        if not self.was_initialized:
            self.initialize()
        maybe_mkdir(self.output_folder)
        if self.unpack_dataset_flag and self.dataset_class is DatasetNumpy:
            unpack_dataset(self.preprocessed_dataset_folder, num_processes=4)
        self.get_dataloaders()
        save_json(self.plans_manager.plans,
                  join(self.output_folder_base, "plans.json"), sort_keys=False)
        save_json(self.dataset_json, join(self.output_folder_base, "dataset.json"))
        self._save_debug_information()

    def _save_debug_information(self):
        dbg = {"trainer_name": self.trainer_name,
               "config": asdict(self.config),
               "configuration": self.configuration_name,
               "fold": self.fold,
               "num_input_channels": self.num_input_channels,
               "device": str(self.device),
               "device_name": torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu",
               "seed": self.seed,
               "torch_version": torch.__version__}
        save_json(dbg, join(self.output_folder, "debug.json"))

    def on_epoch_end(self):
        epoch = self.current_epoch
        if (epoch + 1) % self.config.save_every == 0 and \
                epoch != self.config.num_epochs - 1:
            self.save_checkpoint(join(self.output_folder, "checkpoint_latest.pth"))
        ema = self.logger.my_fantastic_logging["ema_fg_dice"][epoch]
        if self._best_ema is None or ema > self._best_ema:
            self._best_ema = ema
            self.print_to_log_file(f"New best EMA pseudo dice: {ema:.4f}")
            self.save_checkpoint(join(self.output_folder, "checkpoint_best.pth"))
        self.logger.plot_progress_png(self.output_folder)

    def on_train_end(self):
        self.current_epoch -= 1
        self.save_checkpoint(join(self.output_folder, "checkpoint_final.pth"))
        self.current_epoch += 1
        latest = join(self.output_folder, "checkpoint_latest.pth")
        if isfile(latest):
            os.remove(latest)
        for dl in (getattr(self, "dataloader_train", None),
                   getattr(self, "dataloader_val", None)):
            if dl is not None:
                dl.stop()
        self.print_to_log_file("Training done.")

    # ----------------------------------------------------------------- final val
    def perform_actual_validation(self, save_probabilities: bool = False) -> dict:
        """Sliding-window prediction of the validation fold's cases, written
        to ``validation/`` through the plans' writer, and the summary against
        ``gt_segmentations`` in ``validation/summary.json``: Dice, or the
        regression metrics for a translation target (reference
        `nnUNetTrainer.py:1354-1504`). A cascaded configuration stacks the
        previous stage's prediction onto each case one-hot. For each next
        stage, the logits of each validation case that the next stage's
        preprocessed folder holds are resampled to its shape and saved to
        ``predicted_next_stage/<next stage>/<case>.npz``. Each case's seconds
        (read, device, export, next-stage export) go to
        ``validation_case_times``. One process; the SSL target never gets
        here (``_check_ported``)."""
        from ..evaluation.metrics import (compute_metrics_on_folder,
                                          compute_metrics_on_folder_reg)
        from ..inference.export import export_prediction_from_logits, \
            resample_and_save
        from ..inference.predictor import Predictor
        from ..plans.label_handling import convert_labelmap_to_one_hot

        predictor = Predictor(tile_step_size=0.5, use_gaussian=True,
                              use_mirroring=True, allowed_mirroring_axes=None,
                              device=self.device)
        predictor.manual_initialization(
            get_model_builder(self.trainer_name)(
                self.plans_manager, self.dataset_json, self.configuration_manager,
                self.num_input_channels, deep_supervision=False,
                device=self.device),
            [self.model.state_dict()], self.plans_manager,
            self.configuration_manager, self.dataset_json, self.trainer_name,
            self.inference_allowed_mirroring_axes)

        validation_output_folder = join(self.output_folder, "validation")
        maybe_mkdir(validation_output_folder)
        _, val_keys = self.do_split()
        # the previous stage's folder is passed here too (the JAX package
        # leaves it out, so its cascaded stage gets no one-hot channels)
        dataset_val = self.dataset_class(
            self.preprocessed_dataset_folder, val_keys,
            folder_with_segs_from_previous_stage=self._previous_stage_folder())
        next_stages = []
        for stage in self.configuration_manager.next_stage_names or ():
            folder = join(self.preprocessed_dataset_folder_base,
                          "predicted_next_stage", stage)
            maybe_mkdir(folder)
            next_stages.append((DatasetNumpy(join(
                self.preprocessed_dataset_folder_base,
                self.plans_manager.get_configuration(stage).data_identifier)),
                folder))
        self.validation_case_times = {}
        for k in val_keys:
            t0 = time.perf_counter()
            data, _, seg_prev, properties = dataset_val.load_case(k)
            data = np.asarray(data, dtype=np.float32)
            if seg_prev is not None:
                seg_prev = np.asarray(seg_prev)
                if seg_prev.ndim == data.ndim:         # stored with a channel axis
                    seg_prev = seg_prev[0]
                data = np.vstack([data, convert_labelmap_to_one_hot(
                    seg_prev, self.label_manager.foreground_labels, np.float32)])
            t1 = time.perf_counter()
            logits = predictor.predict_sliding_window_return_logits(data)
            t2 = time.perf_counter()
            export_prediction_from_logits(
                logits, properties, self.configuration_manager, self.plans_manager,
                self.dataset_json, join(validation_output_folder, k),
                save_probabilities)
            t3 = time.perf_counter()
            # the same case gives the same logits: they are resampled for the
            # next stage as they are
            for ds_next, folder in next_stages:
                if k in ds_next.identifiers:
                    resample_and_save(logits, ds_next.load_case(k)[0].shape[1:],
                                      join(folder, k), self.plans_manager,
                                      self.configuration_manager, properties,
                                      self.dataset_json)
            self.validation_case_times[k] = {
                "read_s": t1 - t0, "device_s": t2 - t1, "export_s": t3 - t2,
                "next_stage_s": time.perf_counter() - t3}

        gt_folder = join(self.preprocessed_dataset_folder_base, "gt_segmentations")
        summary = join(validation_output_folder, "summary.json")
        rw = self.plans_manager.image_reader_writer_class()
        if self.target_type == "translation":
            metrics = compute_metrics_on_folder_reg(
                gt_folder, validation_output_folder, summary, rw,
                self.dataset_json["file_ending"], num_processes=4)
            self.print_to_log_file(f"Validation (regression): "
                                   f"{metrics['foreground_mean']}")
            return metrics
        lm = self.label_manager
        metrics = compute_metrics_on_folder(
            gt_folder, validation_output_folder, summary, rw,
            self.dataset_json["file_ending"],
            lm.foreground_regions if lm.has_regions else lm.foreground_labels,
            lm.ignore_label, num_processes=4)
        self.print_to_log_file(
            f"Validation complete. Mean Dice: "
            f"{metrics['foreground_mean']['Dice']:.4f}")
        return metrics

    # ----------------------------------------------------------------- checkpoint
    def save_checkpoint(self, filename: str) -> None:
        """The JAX package's pickle schema; ``network_weights`` is the model's
        ``state_dict`` and ``optimizer_state`` the optimizer's, on the CPU."""
        def to_cpu(obj):
            if isinstance(obj, torch.Tensor):
                return obj.detach().cpu()
            if isinstance(obj, dict):
                return {k: to_cpu(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(to_cpu(v) for v in obj)
            return obj

        checkpoint = {
            "network_weights": to_cpu(self.model.state_dict()),
            "optimizer_state": to_cpu(self.optimizer.state_dict()),
            "step": int(self.step),
            "logging": self.logger.get_checkpoint(),
            "_best_ema": self._best_ema,
            "current_epoch": self.current_epoch + 1,
            "init_args": self.my_init_kwargs,
            "trainer_name": self.trainer_name,
            "inference_allowed_mirroring_axes": self.inference_allowed_mirroring_axes,
        }
        save_pickle(checkpoint, filename)

    def load_checkpoint(self, filename_or_checkpoint) -> None:
        """This package's checkpoint, or the JAX package's: its
        ``network_weights`` and ``optimizer_state`` are flax msgpack bytes of
        the params and of the optax state, AdamW's or SGD's, which map onto
        this trainer's optimizer of the same kind
        (``convert.adamw_state_from_optax``, ``convert.sgd_state_from_optax``;
        another raises)."""
        if not self.was_initialized:
            self.initialize()
        ckpt = filename_or_checkpoint
        if isinstance(ckpt, str):
            ckpt = load_pickle(ckpt)
        weights = ckpt["network_weights"]
        if isinstance(weights, (bytes, bytearray)):
            from_optax = {torch.optim.AdamW: adamw_state_from_optax,
                          torch.optim.SGD: sgd_state_from_optax}[type(self.optimizer)]
            self.model.load_state_dict(
                convert_params(msgpack_restore(weights), self.model))
            optimizer_state = self.optimizer.state_dict()
            optimizer_state["state"] = from_optax(
                msgpack_restore(ckpt["optimizer_state"]), self.model)
            self.optimizer.load_state_dict(optimizer_state)
        else:
            self.model.load_state_dict(weights)
            self.optimizer.load_state_dict(ckpt["optimizer_state"])
        self.step = int(ckpt["step"])
        self.logger.load_checkpoint(ckpt["logging"])
        self._best_ema = ckpt["_best_ema"]
        self.current_epoch = ckpt["current_epoch"]
        self.inference_allowed_mirroring_axes = \
            ckpt["inference_allowed_mirroring_axes"]


def load_trainer_from_checkpoint(checkpoint_path: str, device="cuda") -> Trainer:
    """Make a trainer again from the constructor arguments a checkpoint holds."""
    ckpt = load_pickle(checkpoint_path)
    trainer = Trainer(**ckpt["init_args"], device=device)
    trainer.initialize()
    trainer.load_checkpoint(ckpt)
    return trainer
