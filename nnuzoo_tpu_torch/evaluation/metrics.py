"""Segmentation evaluation (this package's copy of
``nnuzoo_tpu/evaluation/metrics.py``; reference
`nnunetv2/evaluation/evaluate_predictions.py:21-437`).

Per-case Dice/IoU/FP/FN/TP/TN/n_pred/n_ref per label or region (ignore label
masked), folder-level means + ``foreground_mean``, written to ``summary.json``
with the reference's tuple-key codec (region tuples serialized as 'a or b').
The regression metrics of the translation target are not copied yet.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..utilities.io import join, load_json, save_json, subfiles


def label_or_region_to_key(label_or_region) -> str:
    return str(label_or_region)


def key_to_label_or_region(key: str):
    try:
        return int(key)
    except ValueError:
        key = key.replace("(", "").replace(")", "")
        return tuple(int(i) for i in key.split(",") if len(i.strip()) > 0)


def save_summary_json(results: dict, output_file: str) -> None:
    results_converted = {
        "foreground_mean": {label_or_region_to_key(k): v
                            for k, v in results["foreground_mean"].items()},
        "mean": {label_or_region_to_key(k): v for k, v in results["mean"].items()},
        "metric_per_case": [
            {"prediction_file": i["prediction_file"],
             "reference_file": i["reference_file"],
             "metrics": {label_or_region_to_key(k): v
                         for k, v in i["metrics"].items()}}
            for i in results["metric_per_case"]],
    }
    save_json(results_converted, output_file)


def load_summary_json(filename: str) -> dict:
    results = load_json(filename)
    results["mean"] = {key_to_label_or_region(k): v
                       for k, v in results["mean"].items()}
    results["metric_per_case"] = [
        {**i, "metrics": {key_to_label_or_region(k): v
                          for k, v in i["metrics"].items()}}
        for i in results["metric_per_case"]]
    return results


def region_or_label_to_mask(segmentation: np.ndarray, region_or_label) -> np.ndarray:
    if np.isscalar(region_or_label):
        return segmentation == region_or_label
    mask = np.zeros_like(segmentation, dtype=bool)
    for r in region_or_label:
        mask |= segmentation == r
    return mask


def compute_tp_fp_fn_tn(mask_ref, mask_pred, ignore_mask=None):
    use = ~ignore_mask if ignore_mask is not None else None
    if use is None:
        tp = int(np.sum(mask_ref & mask_pred))
        fp = int(np.sum(~mask_ref & mask_pred))
        fn = int(np.sum(mask_ref & ~mask_pred))
        tn = int(np.sum(~mask_ref & ~mask_pred))
    else:
        tp = int(np.sum(mask_ref & mask_pred & use))
        fp = int(np.sum(~mask_ref & mask_pred & use))
        fn = int(np.sum(mask_ref & ~mask_pred & use))
        tn = int(np.sum(~mask_ref & ~mask_pred & use))
    return tp, fp, fn, tn


def compute_metrics(reference_file: str, prediction_file: str, image_reader_writer,
                    labels_or_regions, ignore_label: Optional[int] = None) -> dict:
    seg_ref, _ = image_reader_writer.read_seg(reference_file)
    seg_pred, _ = image_reader_writer.read_seg(prediction_file)
    ignore_mask = (seg_ref == ignore_label) if ignore_label is not None else None

    results = {"reference_file": reference_file,
               "prediction_file": prediction_file, "metrics": {}}
    for r in labels_or_regions:
        mask_ref = region_or_label_to_mask(seg_ref, r)
        mask_pred = region_or_label_to_mask(seg_pred, r)
        tp, fp, fn, tn = compute_tp_fp_fn_tn(mask_ref, mask_pred, ignore_mask)
        m = {}
        if tp + fp + fn == 0:
            m["Dice"] = np.nan
            m["IoU"] = np.nan
        else:
            m["Dice"] = 2 * tp / (2 * tp + fp + fn)
            m["IoU"] = tp / (tp + fp + fn)
        m.update({"FP": fp, "TP": tp, "FN": fn, "TN": tn,
                  "n_pred": fp + tp, "n_ref": fn + tp})
        results["metrics"][r if np.isscalar(r) else tuple(r)] = m
    return results


def compute_metrics_on_folder(folder_ref: str, folder_pred: str,
                              output_file: Optional[str], image_reader_writer,
                              file_ending: str, regions_or_labels,
                              ignore_label: Optional[int] = None,
                              num_processes: int = 8, chill: bool = True) -> dict:
    files_pred = subfiles(folder_pred, suffix=file_ending, join_path=False)
    files_ref = subfiles(folder_ref, suffix=file_ending, join_path=False)
    if not chill:
        present = [f in files_pred for f in files_ref]
        assert all(present), "Not all files in folder_ref exist in folder_pred"
    files_ref = [join(folder_ref, f) for f in files_pred if f in files_ref]
    files_pred = [join(folder_pred, f) for f in files_pred
                  if os.path.basename(f) in [os.path.basename(r) for r in files_ref]]

    def one(pair):
        ref, pred = pair
        return compute_metrics(ref, pred, image_reader_writer, regions_or_labels,
                               ignore_label)

    pairs = list(zip(files_ref, files_pred))
    if num_processes <= 1:
        results = [one(p) for p in pairs]
    else:
        with ThreadPoolExecutor(max_workers=num_processes) as pool:
            results = list(pool.map(one, pairs))

    metric_list = list(results[0]["metrics"][
        list(results[0]["metrics"].keys())[0]].keys())
    means = {}
    for r in regions_or_labels:
        key = r if np.isscalar(r) else tuple(r)
        means[key] = {m: float(np.nanmean([rr["metrics"][key][m] for rr in results]))
                      for m in metric_list}
    foreground_mean = {}
    for m in metric_list:
        values = [means[k][m] for k in means
                  if (np.isscalar(k) and k != 0) or (not np.isscalar(k))]
        foreground_mean[m] = float(np.mean(values)) if values else np.nan

    result = {"metric_per_case": results, "mean": means,
              "foreground_mean": foreground_mean}
    if output_file is not None:
        save_summary_json(result, output_file)
    return result


def compute_metrics_on_folder_simple(folder_ref, folder_pred, labels,
                                     output_file=None, num_processes=8,
                                     ignore_label=None, chill=True):
    ending = os.path.splitext(subfiles(folder_ref, join_path=False)[0])[-1]
    from ..imageio.registry import determine_reader_writer_from_file_ending
    example = subfiles(folder_ref)[0]
    rw = determine_reader_writer_from_file_ending(ending, example)()
    return compute_metrics_on_folder(folder_ref, folder_pred, output_file, rw,
                                     ending, labels, ignore_label, num_processes,
                                     chill)
