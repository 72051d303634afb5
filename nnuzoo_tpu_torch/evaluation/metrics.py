"""Segmentation evaluation (this package's copy of
``nnuzoo_tpu/evaluation/metrics.py``; reference
`nnunetv2/evaluation/evaluate_predictions.py:21-437`).

Per-case Dice/IoU/FP/FN/TP/TN/n_pred/n_ref per label or region (ignore label
masked), folder-level means + ``foreground_mean``, written to ``summary.json``
with the reference's tuple-key codec (region tuples serialized as 'a or b').
The translation target's regression metrics (MSE, MAE, PSNR, SSIM, APE, PE;
reference `evaluate_predictions.py:63-171`) are the ``_reg`` functions.
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


# ------------------------------------------------------------------ regression
def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _valid_gaussian_filter(img: np.ndarray, sigma: float, radius: int) -> np.ndarray:
    """Separable 'valid'-mode gaussian convolution (crops ``radius`` per side on
    every axis) — matches the unpadded window convolution the reference's
    monai ``SSIMMetric`` performs."""
    from scipy.ndimage import convolve1d
    k = _gaussian_kernel1d(sigma, radius)
    out = img.astype(np.float64)
    for ax in range(img.ndim):
        out = convolve1d(out, k, axis=ax, mode="constant")
        sl = [slice(None)] * out.ndim
        sl[ax] = slice(radius, out.shape[ax] - radius)
        out = out[tuple(sl)]
    return out


def structural_similarity(pred: np.ndarray, ref: np.ndarray,
                          data_range: float = 1.0, win_size: int = 11,
                          sigma: float = 1.5, k1: float = 0.01,
                          k2: float = 0.03) -> float:
    """Mean SSIM over the valid (fully-supported) window positions, gaussian
    weighting — the reference's monai ``SSIMMetric(spatial_dims=...)`` defaults
    (`nnunetv2/evaluation/evaluate_predictions.py:90-106`)."""
    pred = pred.astype(np.float64)
    ref = ref.astype(np.float64)
    # clamp the window to the smallest spatial extent (kept odd) so small
    # volumes still have a non-empty valid region
    win_size = min([win_size] + [s - (s + 1) % 2 for s in ref.shape])
    radius = win_size // 2
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p = _valid_gaussian_filter(pred, sigma, radius)
    mu_r = _valid_gaussian_filter(ref, sigma, radius)
    var_p = _valid_gaussian_filter(pred * pred, sigma, radius) - mu_p * mu_p
    var_r = _valid_gaussian_filter(ref * ref, sigma, radius) - mu_r * mu_r
    cov = _valid_gaussian_filter(pred * ref, sigma, radius) - mu_p * mu_r
    num = (2 * mu_p * mu_r + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_r ** 2 + c1) * (var_p + var_r + c2)
    return float(np.mean(num / den))


def _reg_spatial_dims(ref: np.ndarray) -> int:
    """Model spatial dims = trailing 3 axes with size-1 axes dropped
    (reference `evaluate_predictions.py:97-99`)."""
    return len([s for s in ref.shape[-3:] if s != 1])


def compute_metrics_reg(reference_file: str, prediction_file: str,
                        image_reader_writer) -> dict:
    """MAE/MSE/PSNR/SSIM/APE/PE for target_type=translation, matching the
    reference's conventions (`nnunetv2/evaluation/evaluate_predictions.py:63-171`):
    PSNR is reported lower-better as ``100 - psnr`` with ``max_val = ref.max()``,
    SSIM lower-better as ``1 - ssim``, APE/PE with both images clipped below at
    0.05 and invalid entries masked."""
    ref, _ = image_reader_writer.read_images([reference_file])
    pred, _ = image_reader_writer.read_images([prediction_file])
    ref = ref.astype(np.float64)
    pred = pred.astype(np.float64)
    mae = float(np.mean(np.abs(ref - pred)))
    mse = float(np.mean((ref - pred) ** 2))
    max_val = float(ref.max())
    psnr = float(10 * np.log10(max_val ** 2 / mse)) if mse > 0 else np.inf
    sdim = max(1, _reg_spatial_dims(ref))
    sshape = ref.shape[-3:][-sdim:] if sdim <= 3 else ref.shape[-sdim:]
    # per-channel SSIM, averaged (monai reduces over the channel axis too)
    ref_ch = ref.reshape((-1, *sshape))
    pred_ch = pred.reshape((-1, *sshape))
    ssim = float(np.mean([structural_similarity(p, r)
                          for p, r in zip(pred_ch, ref_ch)]))
    ref_c = np.clip(ref, 0.05, None)
    pred_c = np.clip(pred, 0.05, None)
    with np.errstate(divide="ignore", invalid="ignore"):
        re_map = (pred_c - ref_c) / ref_c * 100
        pe = float(np.mean(np.ma.masked_invalid(re_map)))
        ape = float(np.mean(np.ma.masked_invalid(np.abs(re_map))))
    return {"reference_file": reference_file, "prediction_file": prediction_file,
            "metrics": {"MSE": mse, "MAE": mae, "PSNR": float(100 - psnr),
                        "SSIM": float(1.0 - ssim), "APE": ape, "PE": pe}}


def compute_metrics_on_folder_reg(folder_ref: str, folder_pred: str,
                                  output_file: Optional[str], image_reader_writer,
                                  file_ending: str, num_processes: int = 8) -> dict:
    files_pred = subfiles(folder_pred, suffix=file_ending, join_path=False)
    files_ref = subfiles(folder_ref, suffix=file_ending, join_path=False)
    common = [f for f in files_pred if f in files_ref]

    def one(f):
        return compute_metrics_reg(join(folder_ref, f), join(folder_pred, f),
                                   image_reader_writer)

    with ThreadPoolExecutor(max_workers=max(1, num_processes)) as pool:
        results = list(pool.map(one, common))
    metric_list = list(results[0]["metrics"].keys())
    means = {m: float(np.nanmean([r["metrics"][m] for r in results]))
             for m in metric_list}
    result = {"metric_per_case": results, "mean": means, "foreground_mean": means}
    if output_file is not None:
        save_json({"mean": means,
                   "metric_per_case": results,
                   "foreground_mean": means}, output_file)
    return result
