"""Entry points of the port's command line (port of the ``train``,
``predict``, ``evaluate_folder``, planning and preprocessing,
``evaluate_simple`` and ``predict_from_modelfolder`` entries of
``nnuzoo_tpu/cli/entry_points.py``; reference ``nnUNetv2_*`` console
scripts). Same flags as the JAX package's; ``-device`` is honoured here and
defaults to ``cuda``, which raises where there is no card. Planning,
preprocessing and evaluation run on the host and touch no device."""

import argparse


def _default_np_for(configurations):
    """Default preprocessing worker count per requested configuration
    (reference uses 8/4/8 for 2d/3d_fullres/3d_lowres)."""
    per_cfg = {"2d": 8, "3d_fullres": 4, "3d_lowres": 8}
    return [per_cfg.get(c, 4) for c in configurations]


def plan_and_preprocess_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli plan_and_preprocess")
    p.add_argument("-d", nargs="+", type=int, required=True, help="dataset ids")
    p.add_argument("-fpe", default="DatasetFingerprintExtractor")
    p.add_argument("-npfp", type=int, default=8)
    p.add_argument("--verify_dataset_integrity", action="store_true")
    p.add_argument("--no_pp", action="store_true",
                   help="plan only, skip preprocessing")
    p.add_argument("--clean", action="store_true")
    p.add_argument("-pl", default="ExperimentPlanner")
    p.add_argument("-gpu_memory_target", type=float, default=8)
    p.add_argument("-preprocessor_name", default="DefaultPreprocessor")
    p.add_argument("-overwrite_target_spacing", nargs="+", type=float, default=None)
    p.add_argument("-overwrite_plans_name", default=None)
    p.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    p.add_argument("-np", nargs="+", type=int, default=None)
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)

    from ..planning.api import extract_fingerprints, plan_experiments, preprocess
    extract_fingerprints(a.d, a.npfp, a.verify_dataset_integrity, a.clean, a.verbose)
    plans_names = plan_experiments(
        a.d, experiment_planner_name=a.pl,
        gpu_memory_target_in_gb=a.gpu_memory_target,
        preprocess_class_name=a.preprocessor_name,
        overwrite_target_spacing=a.overwrite_target_spacing,
        overwrite_plans_name=a.overwrite_plans_name)
    if not a.no_pp:
        # the plans that the planner wrote (the reference's order; the JAX
        # package's entry preprocesses nnUNetPlans whatever the planner)
        np_ = a.np if a.np is not None else _default_np_for(a.c)
        for d, plans_name in zip(a.d, plans_names):
            preprocess([d], plans_name, configurations=a.c, num_processes=np_,
                       verbose=a.verbose)


def extract_fingerprint_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli extract_fingerprint")
    p.add_argument("-d", nargs="+", type=int, required=True)
    p.add_argument("-np", type=int, default=8)
    p.add_argument("--verify_dataset_integrity", action="store_true")
    p.add_argument("--clean", action="store_true")
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)
    from ..planning.api import extract_fingerprints
    extract_fingerprints(a.d, a.np, a.verify_dataset_integrity, a.clean, a.verbose)


def plan_experiment_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli plan_experiment")
    p.add_argument("-d", nargs="+", type=int, required=True)
    p.add_argument("-pl", default="ExperimentPlanner")
    p.add_argument("-gpu_memory_target", type=float, default=8)
    p.add_argument("-preprocessor_name", default="DefaultPreprocessor")
    p.add_argument("-overwrite_target_spacing", nargs="+", type=float, default=None)
    p.add_argument("-overwrite_plans_name", default=None)
    a = p.parse_args(argv)
    from ..planning.api import plan_experiments
    plan_experiments(a.d, experiment_planner_name=a.pl,
                     gpu_memory_target_in_gb=a.gpu_memory_target,
                     preprocess_class_name=a.preprocessor_name,
                     overwrite_target_spacing=a.overwrite_target_spacing,
                     overwrite_plans_name=a.overwrite_plans_name)


def preprocess_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli preprocess")
    p.add_argument("-d", nargs="+", type=int, required=True)
    p.add_argument("-plans_name", default="nnUNetPlans")
    p.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    p.add_argument("-np", nargs="+", type=int, default=None)
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)
    from ..planning.api import preprocess
    np_ = a.np if a.np is not None else _default_np_for(a.c)
    preprocess(a.d, a.plans_name, configurations=a.c, num_processes=np_,
               verbose=a.verbose)


def train_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli train")
    p.add_argument("dataset_name_or_id")
    p.add_argument("configuration")
    p.add_argument("fold")
    p.add_argument("-tr", default="nnUNetTrainer")
    p.add_argument("-p", default="nnUNetPlans")
    p.add_argument("-num_epochs", type=int, default=None)
    p.add_argument("--c", action="store_true", dest="continue_training")
    p.add_argument("--val", action="store_true", help="validation only")
    p.add_argument("--val_best", action="store_true")
    p.add_argument("--skip_val", action="store_true")
    p.add_argument("--npz", action="store_true",
                   help="export validation softmax probabilities")
    p.add_argument("-device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("-num_gpus", type=int, default=1,
                   help="one device only; other values are refused")
    a = p.parse_args(argv)
    if a.num_gpus != 1:
        p.error("nnuzoo_tpu_torch trains on one device (-num_gpus 1)")
    from ..run.run_training import run_training
    return run_training(a.dataset_name_or_id, a.configuration, a.fold, a.tr, a.p,
                 num_epochs=a.num_epochs, continue_training=a.continue_training,
                 only_run_validation=a.val, validate_with_best=a.val_best,
                 skip_validation=a.skip_val,
                 export_validation_probabilities=a.npz, device=a.device)


def predict_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli predict")
    p.add_argument("-i", required=True, help="input folder")
    p.add_argument("-o", required=True, help="output folder")
    p.add_argument("-d", required=True, help="dataset name or id")
    p.add_argument("-c", required=True, help="configuration")
    p.add_argument("-tr", default="nnUNetTrainer")
    p.add_argument("-p", default="nnUNetPlans")
    p.add_argument("-f", nargs="+", default=(0, 1, 2, 3, 4))
    p.add_argument("-step_size", type=float, default=0.5)
    p.add_argument("-chk", default="checkpoint_final.pth")
    p.add_argument("--disable_tta", action="store_true")
    p.add_argument("--save_probabilities", action="store_true")
    p.add_argument("--continue_prediction", action="store_true")
    p.add_argument("-npp", type=int, default=3,
                   help="accepted for the reference's flags: one thread preprocesses")
    p.add_argument("-nps", type=int, default=3,
                   help="accepted for the reference's flags: two threads export")
    p.add_argument("-prev_stage_predictions", default=None)
    p.add_argument("-num_parts", type=int, default=1)
    p.add_argument("-part_id", type=int, default=0)
    p.add_argument("-device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)

    from ..inference.predictor import Predictor
    from ..utilities.dataset_name_id import maybe_convert_to_dataset_name
    from ..utilities.file_path_utilities import get_output_folder
    model_folder = get_output_folder(maybe_convert_to_dataset_name(a.d), a.tr,
                                     a.p, a.c)
    predictor = Predictor(tile_step_size=a.step_size, use_gaussian=True,
                          use_mirroring=not a.disable_tta, verbose=a.verbose,
                          device=a.device)
    predictor.initialize_from_trained_model_folder(model_folder, a.f, a.chk)
    predictor.predict_from_files(a.i, a.o, save_probabilities=a.save_probabilities,
                                 overwrite=not a.continue_prediction,
                                 num_parts=a.num_parts, part_id=a.part_id,
                                 folder_with_segs_from_prev_stage=
                                 a.prev_stage_predictions)
    return predictor


def evaluate_folder_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli evaluate_folder")
    p.add_argument("gt_folder")
    p.add_argument("pred_folder")
    p.add_argument("-djfile", required=True, help="dataset.json path")
    p.add_argument("-pfile", required=True, help="plans.json path")
    p.add_argument("-o", default=None, help="output summary json")
    p.add_argument("-np", type=int, default=8)
    p.add_argument("--chill", action="store_true")
    a = p.parse_args(argv)

    from ..evaluation.metrics import (compute_metrics_on_folder,
                                      compute_metrics_on_folder_reg)
    from ..plans.plans_handler import PlansManager
    from ..utilities.io import join, load_json
    dataset_json = load_json(a.djfile)
    plans_manager = PlansManager(load_json(a.pfile))
    rw = plans_manager.image_reader_writer_class()
    out_file = a.o if a.o else join(a.pred_folder, "summary.json")
    if dataset_json.get("target_type", "segmentation") == "translation":
        metrics = compute_metrics_on_folder_reg(
            a.gt_folder, a.pred_folder, out_file, rw, dataset_json["file_ending"],
            a.np)
    else:
        lm = plans_manager.get_label_manager(dataset_json)
        metrics = compute_metrics_on_folder(
            a.gt_folder, a.pred_folder, out_file, rw, dataset_json["file_ending"],
            lm.foreground_regions if lm.has_regions else lm.foreground_labels,
            lm.ignore_label, a.np, chill=True)
    print(f"summary written to {out_file}")
    return metrics


def evaluate_simple_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli evaluate_simple")
    p.add_argument("gt_folder")
    p.add_argument("pred_folder")
    p.add_argument("-l", nargs="+", type=int, required=True, help="labels")
    p.add_argument("-il", type=int, default=None, help="ignore label")
    p.add_argument("-o", default=None)
    p.add_argument("-np", type=int, default=8)
    a = p.parse_args(argv)
    from ..evaluation.metrics import compute_metrics_on_folder_simple
    return compute_metrics_on_folder_simple(a.gt_folder, a.pred_folder, a.l, a.o,
                                            a.np, a.il)


def predict_from_modelfolder_entry(argv=None):
    p = argparse.ArgumentParser("nnuzoo_tpu_torch.cli predict_from_modelfolder")
    p.add_argument("-i", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("-m", required=True, help="trained model folder")
    p.add_argument("-f", nargs="+", default=None)
    p.add_argument("-step_size", type=float, default=0.5)
    p.add_argument("-chk", default="checkpoint_final.pth")
    p.add_argument("--disable_tta", action="store_true")
    p.add_argument("--save_probabilities", action="store_true")
    p.add_argument("--continue_prediction", action="store_true")
    p.add_argument("-num_parts", type=int, default=1)
    p.add_argument("-part_id", type=int, default=0)
    p.add_argument("-prev_stage_predictions", default=None)
    p.add_argument("-device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)
    from ..inference.predictor import Predictor
    predictor = Predictor(tile_step_size=a.step_size, use_gaussian=True,
                          use_mirroring=not a.disable_tta, verbose=a.verbose,
                          device=a.device)
    predictor.initialize_from_trained_model_folder(a.m, a.f, a.chk)
    predictor.predict_from_files(a.i, a.o, save_probabilities=a.save_probabilities,
                                 overwrite=not a.continue_prediction,
                                 num_parts=a.num_parts, part_id=a.part_id,
                                 folder_with_segs_from_prev_stage=
                                 a.prev_stage_predictions)
    return predictor


COMMANDS = {"train": train_entry, "predict": predict_entry,
            "evaluate_folder": evaluate_folder_entry,
            "plan_and_preprocess": plan_and_preprocess_entry,
            "extract_fingerprint": extract_fingerprint_entry,
            "plan_experiment": plan_experiment_entry,
            "preprocess": preprocess_entry,
            "evaluate_simple": evaluate_simple_entry,
            "predict_from_modelfolder": predict_from_modelfolder_entry}


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m nnuzoo_tpu_torch.cli "
                         f"{{{','.join(COMMANDS)}}} [arguments]")
    return COMMANDS[argv[0]](argv[1:])
