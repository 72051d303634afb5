"""Entry points of the port's command line (port of the ``train``,
``predict`` and ``evaluate_folder`` entries of
``nnuzoo_tpu/cli/entry_points.py``; reference ``nnUNetv2_*`` console
scripts). Same flags as the JAX package's; ``-device`` is honoured here and
defaults to ``cuda``, which raises where there is no card."""

import argparse


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
    run_training(a.dataset_name_or_id, a.configuration, a.fold, a.tr, a.p,
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

    from ..evaluation.metrics import compute_metrics_on_folder
    from ..plans.plans_handler import PlansManager
    from ..utilities.io import join, load_json
    dataset_json = load_json(a.djfile)
    if dataset_json.get("target_type", "segmentation") != "segmentation":
        raise NotImplementedError("the regression metrics of the translation "
                                  "target are not in nnuzoo_tpu_torch yet")
    plans_manager = PlansManager(load_json(a.pfile))
    out_file = a.o if a.o else join(a.pred_folder, "summary.json")
    lm = plans_manager.get_label_manager(dataset_json)
    metrics = compute_metrics_on_folder(
        a.gt_folder, a.pred_folder, out_file,
        plans_manager.image_reader_writer_class(), dataset_json["file_ending"],
        lm.foreground_regions if lm.has_regions else lm.foreground_labels,
        lm.ignore_label, a.np, chill=True)
    print(f"summary written to {out_file}")
    return metrics


COMMANDS = {"train": train_entry, "predict": predict_entry,
            "evaluate_folder": evaluate_folder_entry}


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m nnuzoo_tpu_torch.cli "
                         f"{{{','.join(COMMANDS)}}} [arguments]")
    COMMANDS[argv[0]](argv[1:])
