"""Prediction export: logits -> segmentation in original geometry
(reference: `nnunetv2/inference/export_prediction.py:13-160`).

Copy of ``nnuzoo_tpu/inference/export.py``; the port imports nothing of the
JAX package.

Inverts preprocessing: resample to pre-crop shape -> nonlin+argmax/threshold ->
un-crop -> un-transpose -> write via the dataset's reader/writer.
"""

from typing import Union

import numpy as np

from ..plans.label_handling import LabelManager
from ..plans.plans_handler import ConfigurationManager, PlansManager
from ..preprocessing.cropping import bounding_box_to_slice
from ..utilities.io import load_json, save_pickle


def convert_predicted_logits_to_segmentation_with_correct_shape(
        predicted_logits: np.ndarray, plans_manager: PlansManager,
        configuration_manager: ConfigurationManager, label_manager: LabelManager,
        properties_dict: dict, return_probabilities: bool = False):
    current_spacing = configuration_manager.spacing if \
        len(configuration_manager.spacing) == \
        len(properties_dict["shape_after_cropping_and_before_resampling"]) else \
        [properties_dict["spacing"][0], *configuration_manager.spacing]
    target_spacing = [properties_dict["spacing"][i]
                      for i in plans_manager.transpose_forward]
    target_shape = properties_dict["shape_after_cropping_and_before_resampling"]

    if return_probabilities:
        predicted_logits = configuration_manager.resampling_fn_probabilities(
            predicted_logits, target_shape, current_spacing, target_spacing)
        probabilities = label_manager.apply_inference_nonlin(predicted_logits)
        segmentation = label_manager.convert_probabilities_to_segmentation(probabilities)
    else:
        probabilities = label_manager.apply_inference_nonlin(predicted_logits)
        segmentation = label_manager.convert_probabilities_to_segmentation(probabilities)
        # nearest-resample the segmentation to the pre-crop shape
        fn = configuration_manager.resampling_fn_probabilities
        segmentation = fn(segmentation[None].astype(np.float64), target_shape,
                          current_spacing, target_spacing, order=0)[0]
        probabilities = None

    seg_dtype = np.uint8 if len(label_manager.foreground_labels) < 255 else np.uint16
    seg_reverted = np.zeros(properties_dict["shape_before_cropping"], dtype=seg_dtype)
    slicer = bounding_box_to_slice(properties_dict["bbox_used_for_cropping"])
    seg_reverted[slicer] = segmentation.astype(seg_dtype)
    seg_reverted = seg_reverted.transpose(plans_manager.transpose_backward)

    if return_probabilities:
        probabilities = label_manager.revert_cropping_on_probabilities(
            probabilities, properties_dict["bbox_used_for_cropping"],
            properties_dict["shape_before_cropping"])
        probabilities = probabilities.transpose(
            [0] + [i + 1 for i in plans_manager.transpose_backward])
        return seg_reverted, probabilities
    return seg_reverted


def export_prediction_from_logits(predicted_logits: np.ndarray,
                                  properties_dict: dict,
                                  configuration_manager: ConfigurationManager,
                                  plans_manager: PlansManager,
                                  dataset_json: Union[dict, str],
                                  output_file_truncated: str,
                                  save_probabilities: bool = False) -> None:
    if isinstance(dataset_json, str):
        dataset_json = load_json(dataset_json)
    label_manager = plans_manager.get_label_manager(dataset_json)
    ret = convert_predicted_logits_to_segmentation_with_correct_shape(
        predicted_logits, plans_manager, configuration_manager, label_manager,
        properties_dict, return_probabilities=save_probabilities)
    if save_probabilities:
        segmentation, probabilities = ret
        np.savez_compressed(output_file_truncated + ".npz",
                            probabilities=probabilities)
        save_pickle(properties_dict, output_file_truncated + ".pkl")
    else:
        segmentation = ret
    rw = plans_manager.image_reader_writer_class()
    rw.write_seg(segmentation, output_file_truncated + dataset_json["file_ending"],
                 properties_dict)


def resample_and_save(predicted_logits: np.ndarray, target_shape,
                      output_file_truncated: str, plans_manager: PlansManager,
                      configuration_manager: ConfigurationManager,
                      properties_dict: dict, dataset_json: dict) -> None:
    """Cascade next-stage input: save resampled softmax argmax as npz (reference
    `export_prediction.py:123-160`)."""
    current_spacing = configuration_manager.spacing if \
        len(configuration_manager.spacing) == len(target_shape) else \
        [properties_dict["spacing"][0], *configuration_manager.spacing]
    target_spacing = configuration_manager.spacing if \
        len(configuration_manager.spacing) == len(target_shape) else current_spacing
    resampled = configuration_manager.resampling_fn_probabilities(
        predicted_logits, target_shape, current_spacing, target_spacing)
    label_manager = plans_manager.get_label_manager(dataset_json)
    seg = label_manager.convert_logits_to_segmentation(resampled)
    np.savez_compressed(output_file_truncated + ".npz", seg=seg.astype(np.uint8))
