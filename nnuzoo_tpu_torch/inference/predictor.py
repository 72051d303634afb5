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

``initialize_from_trained_model_folder`` reads both kinds of checkpoint: the
port's own (``network_weights`` a ``state_dict``) and the JAX package's
(serialised flax parameters, read by ``utilities.flax_msgpack`` and
converted by ``convert.convert_params``). ``predict_from_files`` keeps the
JAX predictor's pipeline: one thread preprocesses the next case while the
device runs this one, and two threads export; a task that fails raises in
the caller. It records each case's seconds in ``case_times``.
"""

import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..convert import convert_params
from ..models.registry import get_model_builder
from ..plans.label_handling import convert_labelmap_to_one_hot, \
    determine_num_input_channels
from ..plans.plans_handler import PlansManager
from ..preprocessing.preprocessor import DefaultPreprocessor
from ..utilities.dataset_utils import create_lists_from_split_dataset_folder, \
    get_identifiers_from_split_dataset_folder
from ..utilities.flax_msgpack import msgpack_restore
from ..utilities.io import isfile, join, load_json, load_pickle, maybe_mkdir, \
    save_json
from .export import convert_predicted_logits_to_segmentation_with_correct_shape, \
    export_prediction_from_logits
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
        self.case_times = {}            # predict_from_files: output -> seconds
        self._loaded_params = None

    # ------------------------------------------------------------------ init
    def initialize_from_trained_model_folder(self, model_training_output_dir: str,
                                             use_folds=None,
                                             checkpoint_name: str =
                                             "checkpoint_final.pth"):
        """Load a trained model folder: its ``plans.json`` and ``dataset.json``
        and each fold's checkpoint. ``network_weights`` is a ``state_dict``
        where this package's ``Trainer`` wrote it, and serialised flax
        parameters (bytes) where the JAX package's did."""
        if use_folds is None:
            use_folds = self.auto_detect_available_folds(
                model_training_output_dir, checkpoint_name)
        dataset_json = load_json(join(model_training_output_dir, "dataset.json"))
        plans_manager = PlansManager(
            load_json(join(model_training_output_dir, "plans.json")))

        if isinstance(use_folds, (int, str)):
            use_folds = [use_folds]
        weights = []
        trainer_name = configuration_name = mirroring_axes = None
        for f in use_folds:
            f = int(f) if f != "all" else f
            ckpt = load_pickle(join(model_training_output_dir, f"fold_{f}",
                                    checkpoint_name))
            if trainer_name is None:
                trainer_name = ckpt["trainer_name"]
                configuration_name = ckpt["init_args"]["configuration"]
                mirroring_axes = ckpt.get("inference_allowed_mirroring_axes")
            weights.append(ckpt["network_weights"])

        configuration_manager = plans_manager.get_configuration(configuration_name)
        num_input_channels = determine_num_input_channels(
            plans_manager, configuration_manager, dataset_json)
        model = get_model_builder(trainer_name)(
            plans_manager, dataset_json, configuration_manager,
            num_input_channels, deep_supervision=False, device=self.device)
        parameters = []
        for w in weights:
            if isinstance(w, (bytes, bytearray)):
                parameters.append(convert_params(msgpack_restore(w), model))
            elif isinstance(w, dict):
                parameters.append({k: torch.as_tensor(v) for k, v in w.items()})
            else:
                raise TypeError(f"network_weights of type {type(w).__name__} is "
                                "neither a state_dict nor serialised flax "
                                "parameters")
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

    # ------------------------------------------------------------------ files
    def predict_from_files(self, list_of_lists_or_source_folder,
                           output_folder_or_list_of_truncated_output_files,
                           save_probabilities: bool = False,
                           overwrite: bool = True,
                           num_parts: int = 1, part_id: int = 0,
                           folder_with_segs_from_prev_stage: Optional[str] = None):
        """Predict every case of a raw folder (``{ident}_{CCCC}{ending}``) or
        of a list of per-case file lists, and write each segmentation (and
        with ``save_probabilities`` a ``.npz``/``.pkl``) through the plans'
        writer (reference `predict_from_raw_data.py:predict_from_files`)."""
        dataset_json = self.dataset_json
        ending = dataset_json["file_ending"]
        if isinstance(list_of_lists_or_source_folder, str):
            idents = get_identifiers_from_split_dataset_folder(
                list_of_lists_or_source_folder, ending)
            list_of_lists = create_lists_from_split_dataset_folder(
                list_of_lists_or_source_folder, ending, idents)
        else:
            list_of_lists = list_of_lists_or_source_folder
            idents = [os.path.basename(f[0])[:-(len(ending) + 5)]
                      for f in list_of_lists]

        if isinstance(output_folder_or_list_of_truncated_output_files, str):
            out_folder = output_folder_or_list_of_truncated_output_files
            maybe_mkdir(out_folder)
            out_truncated = [join(out_folder, i) for i in idents]
        else:
            out_truncated = output_folder_or_list_of_truncated_output_files
            out_folder = os.path.dirname(out_truncated[0]) if out_truncated else None

        # num_parts striping (reference `:187`)
        list_of_lists = list_of_lists[part_id::num_parts]
        out_truncated = out_truncated[part_id::num_parts]

        if not overwrite:
            keep = [not isfile(o + ending) for o in out_truncated]
            list_of_lists = [l for l, k in zip(list_of_lists, keep) if k]
            out_truncated = [o for o, k in zip(out_truncated, keep) if k]

        if out_folder is not None:
            save_json({"tile_step_size": self.tile_step_size,
                       "use_gaussian": self.use_gaussian,
                       "use_mirroring": self.use_mirroring,
                       "checkpoint_trainer": self.trainer_name},
                      join(out_folder, "predict_from_raw_data_args.json"))

        preprocessor = DefaultPreprocessor(verbose=self.verbose)
        self.case_times = {o: {} for o in out_truncated}

        def prep(files, out_trunc):
            return self._preprocess_one(preprocessor, files,
                                        folder_with_segs_from_prev_stage,
                                        self.case_times[out_trunc])

        def export(logits, properties, out_trunc):
            t0 = time.perf_counter()
            export_prediction_from_logits(
                logits, properties, self.configuration_manager,
                self.plans_manager, dataset_json, out_trunc, save_probabilities)
            self.case_times[out_trunc]["export_s"] = time.perf_counter() - t0

        # the preprocessing of case i+1 runs beside the device's work on case
        # i (one case ahead, so host memory holds at most two preprocessed
        # cases), and the export off the critical path; fut.result() re-raises
        cases = list(zip(list_of_lists, out_truncated))
        with ThreadPoolExecutor(max_workers=1) as prep_pool, \
                ThreadPoolExecutor(max_workers=2) as export_pool:
            ahead = prep_pool.submit(prep, *cases[0]) if cases else None
            export_futures = []
            for i, (_, out_trunc) in enumerate(cases):
                data, properties = ahead.result()
                if i + 1 < len(cases):
                    ahead = prep_pool.submit(prep, *cases[i + 1])
                t0 = time.perf_counter()
                logits = self.predict_logits_from_preprocessed_data(data)
                self.case_times[out_trunc]["device_s"] = time.perf_counter() - t0
                export_futures.append(export_pool.submit(
                    export, logits, properties, out_trunc))
                if self.verbose:
                    print(f"predicted {out_trunc}")
            for ef in export_futures:
                ef.result()

    def _preprocess_one(self, preprocessor, files, prev_stage_folder,
                        times: Optional[dict] = None):
        """Read and preprocess one case through ``run_case``: (data,
        properties); ``times`` gets its read and preprocess seconds. With a
        previous-stage folder, that stage's segmentation (``ident +
        file_ending``) is cropped and resampled with the image and stacked
        onto its channels one-hot; an ``ident.npz`` (the next-stage input the
        JAX trainer writes) is taken where no segmentation file is there."""
        ident = os.path.basename(files[0]).split(".")[0][:-5]
        seg_file = None
        if prev_stage_folder is not None:
            cand = join(prev_stage_folder, ident + self.dataset_json["file_ending"])
            if os.path.isfile(cand):
                seg_file = cand
        data, seg, properties = preprocessor.run_case(
            files, seg_file, self.plans_manager, self.configuration_manager,
            self.dataset_json, times)
        if prev_stage_folder is not None:
            seg_prev = seg[0] if seg_file is not None else \
                np.load(join(prev_stage_folder, ident + ".npz"))["seg"]
            data = np.vstack([data, convert_labelmap_to_one_hot(
                seg_prev, self.label_manager.foreground_labels, np.float32)])
        return data, properties

    # ------------------------------------------------------------------ npy APIs
    def predict_single_npy_array(self, input_image: np.ndarray,
                                 image_properties: dict,
                                 segmentation_previous_stage: np.ndarray = None,
                                 output_file_truncated: Optional[str] = None,
                                 save_or_return_probabilities: bool = False):
        """Predict one (c, x, y, z) raw array (reference
        `predict_from_raw_data.py:predict_single_npy_array`). With
        ``output_file_truncated`` the result is written through the plans'
        writer and None returned; otherwise the segmentation in the input's
        geometry (and the probabilities when ``save_or_return_probabilities``)
        is returned. ``segmentation_previous_stage`` (x, y, z) is a cascade's
        previous-stage segmentation, stacked onto the channels one-hot."""
        props = dict(image_properties)
        data, seg = DefaultPreprocessor(verbose=self.verbose).run_case_npy(
            input_image,
            segmentation_previous_stage[None].astype(np.int8)
            if segmentation_previous_stage is not None else None,
            props, self.plans_manager, self.configuration_manager,
            self.dataset_json)
        if segmentation_previous_stage is not None:
            data = np.vstack([data, convert_labelmap_to_one_hot(
                seg[0], self.label_manager.foreground_labels, np.float32)])
        logits = self.predict_logits_from_preprocessed_data(data)
        if output_file_truncated is not None:
            export_prediction_from_logits(
                logits, props, self.configuration_manager, self.plans_manager,
                self.dataset_json, output_file_truncated,
                save_or_return_probabilities)
            return None
        return convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, self.plans_manager, self.configuration_manager,
            self.label_manager, props,
            return_probabilities=save_or_return_probabilities)

    def predict_from_list_of_npy_arrays(self, image_list, segs_prev_stage,
                                        properties_list, truncated_output_files,
                                        save_probabilities: bool = False):
        """``predict_single_npy_array`` for each case (reference
        `predict_from_raw_data.py:predict_from_list_of_npy_arrays`)."""
        if segs_prev_stage is None:
            segs_prev_stage = [None] * len(image_list)
        if truncated_output_files is None:
            truncated_output_files = [None] * len(image_list)
        return [self.predict_single_npy_array(img, props, seg_prev, out,
                                              save_probabilities)
                for img, seg_prev, props, out in zip(
                    image_list, segs_prev_stage, properties_list,
                    truncated_output_files)]
