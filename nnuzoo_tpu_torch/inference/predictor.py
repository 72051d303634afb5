"""Sliding-window predictor (port of ``nnuzoo_tpu/inference/predictor.py``,
reference `nnunetv2/inference/predict_from_raw_data.py:37-974`).

Gaussian-weighted sliding-window accumulation (step = tile_step_size * patch),
mirror TTA over all axis combinations, fold-logit averaging. Tiles run through
the model in batches of ``tile_batch_size``; the volume is moved to the device
once, tiles are cut there, and the Gaussian-weighted sums build up in device
buffers, so the host sees one transfer in and one out per volume. A 2d
configuration on a 3d volume slides within each slice.

Eager PyTorch compiles nothing per shape, so unlike the JAX predictor the
buffers are the padded volume's exact shape and the last tile batch runs
short instead of being padded to ``tile_batch_size``.
"""

import itertools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.registry import get_model_builder
from ..plans.label_handling import determine_num_input_channels
from ..plans.plans_handler import PlansManager
from ..preprocessing.preprocessor import DefaultPreprocessor
from ..utilities.io import isfile, join, load_json, load_pickle
from .export import convert_predicted_logits_to_segmentation_with_correct_shape
from .sliding_window import (compute_gaussian, get_sliding_window_slicers,
                             pad_nd_image)


class Predictor:
    def __init__(self, tile_step_size: float = 0.5, use_gaussian: bool = True,
                 use_mirroring: bool = True,
                 allowed_mirroring_axes: Optional[Tuple[int, ...]] = None,
                 tile_batch_size: int = 4, verbose: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.tile_step_size = tile_step_size
        self.use_gaussian = use_gaussian
        self.use_mirroring = use_mirroring
        self.allowed_mirroring_axes = allowed_mirroring_axes
        self.tile_batch_size = tile_batch_size
        self.verbose = verbose

        self.model = None
        self.list_of_parameters = None
        self.plans_manager = None
        self.configuration_manager = None
        self.dataset_json = None
        self.label_manager = None
        self.trainer_name = None
        self.forward_count = 0          # model forwards run by tile_forward
        self._loaded_params = None

    # ------------------------------------------------------------------ init
    def initialize_from_trained_model_folder(self, model_training_output_dir: str,
                                             use_folds=None,
                                             checkpoint_name: str =
                                             "checkpoint_final.pth"):
        """Load a model that this package's ``Trainer`` trained: the folder's
        ``plans.json`` and ``dataset.json`` and each fold's checkpoint, whose
        ``network_weights`` is a ``state_dict``. A checkpoint of the JAX
        package (serialised flax parameters) is not read yet."""
        if use_folds is None:
            use_folds = self.auto_detect_available_folds(
                model_training_output_dir, checkpoint_name)
        dataset_json = load_json(join(model_training_output_dir, "dataset.json"))
        plans_manager = PlansManager(
            load_json(join(model_training_output_dir, "plans.json")))

        if isinstance(use_folds, (int, str)):
            use_folds = [use_folds]
        parameters = []
        trainer_name = configuration_name = mirroring_axes = None
        for f in use_folds:
            f = int(f) if f != "all" else f
            ckpt = load_pickle(join(model_training_output_dir, f"fold_{f}",
                                    checkpoint_name))
            if not isinstance(ckpt["network_weights"], dict):
                raise NotImplementedError(
                    "this checkpoint holds serialised flax parameters (the JAX "
                    "package wrote it); nnuzoo_tpu_torch reads its own "
                    "checkpoints only so far")
            if trainer_name is None:
                trainer_name = ckpt["trainer_name"]
                configuration_name = ckpt["init_args"]["configuration"]
                mirroring_axes = ckpt.get("inference_allowed_mirroring_axes")
            parameters.append({k: torch.as_tensor(v)
                               for k, v in ckpt["network_weights"].items()})

        configuration_manager = plans_manager.get_configuration(configuration_name)
        num_input_channels = determine_num_input_channels(
            plans_manager, configuration_manager, dataset_json)
        model = get_model_builder(trainer_name)(
            plans_manager, dataset_json, configuration_manager,
            num_input_channels, deep_supervision=False, device=self.device)
        self.manual_initialization(model, parameters, plans_manager,
                                   configuration_manager, dataset_json,
                                   trainer_name, mirroring_axes)

    @staticmethod
    def auto_detect_available_folds(model_training_output_dir, checkpoint_name):
        folds = []
        for d in sorted(os.listdir(model_training_output_dir)):
            if d.startswith("fold_") and d != "fold_all" and isfile(
                    join(model_training_output_dir, d, checkpoint_name)):
                folds.append(int(d.split("_")[1]))
        if not folds:
            raise RuntimeError(f"No usable folds in {model_training_output_dir}")
        return folds

    def manual_initialization(self, model, params_list, plans_manager,
                              configuration_manager, dataset_json,
                              trainer_name, inference_allowed_mirroring_axes):
        """``model`` is the port's ``nn.Module``; ``params_list`` holds one
        ``state_dict`` per fold (see ``nnuzoo_tpu_torch.convert``)."""
        self.model = model.to(self.device).eval()
        self.list_of_parameters = params_list
        self.plans_manager = plans_manager
        self.configuration_manager = configuration_manager
        self.dataset_json = dataset_json
        self.trainer_name = trainer_name
        self.label_manager = plans_manager.get_label_manager(dataset_json)
        if self.allowed_mirroring_axes is None:
            self.allowed_mirroring_axes = inference_allowed_mirroring_axes
        self._loaded_params = None

    def _load(self, params) -> None:
        if params is not self._loaded_params:
            self.model.load_state_dict(params)
            self._loaded_params = params

    def tile_forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, *patch, C) channels-last on the device -> (B, *patch, heads),
        averaged over mirror TTA."""
        mirror_axes = tuple(self.allowed_mirroring_axes or ()) \
            if self.use_mirroring else ()
        combos = [c for i in range(len(mirror_axes))
                  for c in itertools.combinations(mirror_axes, i + 1)]
        with torch.inference_mode():
            pred = self.model(x)[0]
            for combo in combos:
                axes = [a + 1 for a in combo]
                pred = pred + self.model(x.flip(axes))[0].flip(axes)
            self.forward_count += len(combos) + 1
            return pred / (len(combos) + 1)

    # ------------------------------------------------------------------ sliding window
    def predict_sliding_window_return_logits(self, data: np.ndarray,
                                             params=None) -> np.ndarray:
        """data: (c, *spatial) preprocessed numpy. Returns (num_heads, *spatial)."""
        if self.model is None:
            raise RuntimeError("predictor not initialized")
        self._load(self.list_of_parameters[0] if params is None else params)
        patch_size = tuple(self.configuration_manager.patch_size)

        data_padded, revert_slicer = pad_nd_image(data, patch_size)
        slicers = get_sliding_window_slicers(data_padded.shape[1:], patch_size,
                                             self.tile_step_size)
        gaussian = compute_gaussian(patch_size) if self.use_gaussian else \
            np.ones(patch_size, dtype=np.float32)
        logits = self._device_accumulate(data_padded, slicers, gaussian,
                                         patch_size)
        if not torch.isfinite(logits).all():
            raise RuntimeError("Non-finite values in accumulated logits")
        logits = logits.cpu().numpy()
        return logits[(slice(None),) + revert_slicer[1:]] \
            if len(revert_slicer) > 1 else logits[revert_slicer]

    @torch.inference_mode()
    def _device_accumulate(self, data_padded, slicers, gaussian, patch_size):
        spatial = data_padded.shape[1:]
        num_heads = self.label_manager.num_segmentation_heads
        # effective patch in the full spatial space (2d-on-3d spans one slice)
        patch_eff = (1,) * (len(spatial) - len(patch_size)) + patch_size
        dev = self.device
        data_dev = torch.from_numpy(np.ascontiguousarray(data_padded)).to(dev)
        logits_buf = torch.zeros((num_heads, *spatial), dtype=torch.float32,
                                 device=dev)
        weights_buf = torch.zeros(spatial, dtype=torch.float32, device=dev)
        g_dev = torch.from_numpy(gaussian).to(dev).reshape(patch_eff)

        bt = self.tile_batch_size
        for i in range(0, len(slicers), bt):
            batch_slicers = slicers[i:i + bt]
            x = torch.stack([data_dev[sl] for sl in batch_slicers])
            preds = self.tile_forward(x.movedim(1, -1).contiguous())
            preds = preds.reshape(len(batch_slicers), *patch_eff, num_heads)
            for j, sl in enumerate(batch_slicers):
                # slicer entries after the channel: ints (2d-on-3d z) or slices
                region = tuple(slice(s, s + 1) if isinstance(s, int) else s
                               for s in sl[1:])
                logits_buf[(slice(None),) + region] += preds[j].movedim(-1, 0) * g_dev
                weights_buf[region] += g_dev
        return logits_buf / weights_buf.clamp_min(1e-8)

    def predict_logits_from_preprocessed_data(self, data: np.ndarray) -> np.ndarray:
        """Average logits over folds (reference `:478-513`)."""
        out = None
        for params in self.list_of_parameters:
            pred = self.predict_sliding_window_return_logits(data, params)
            out = pred if out is None else out + pred
        return out / len(self.list_of_parameters)

    # ------------------------------------------------------------------ npy API
    def predict_single_npy_array(self, input_image: np.ndarray,
                                 image_properties: dict,
                                 segmentation_previous_stage: np.ndarray = None,
                                 output_file_truncated: Optional[str] = None,
                                 save_or_return_probabilities: bool = False):
        """Predict one (c, x, y, z) raw array (reference
        `predict_from_raw_data.py:predict_single_npy_array`). Returns the
        segmentation in the input's geometry (and the probabilities when
        ``save_or_return_probabilities``)."""
        if output_file_truncated is not None:
            raise NotImplementedError("writing predictions to files waits for the "
                                      "port's image I/O")
        if segmentation_previous_stage is not None:
            raise NotImplementedError("cascade input from a previous stage is not "
                                      "ported yet (no 2d configuration runs one)")
        props = dict(image_properties)
        data, _ = DefaultPreprocessor(verbose=self.verbose).run_case_npy(
            input_image, None, props, self.plans_manager,
            self.configuration_manager, self.dataset_json)
        logits = self.predict_logits_from_preprocessed_data(data)
        return convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, self.plans_manager, self.configuration_manager,
            self.label_manager, props,
            return_probabilities=save_or_return_probabilities)
