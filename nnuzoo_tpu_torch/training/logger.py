"""Training logger (reference: `nnunetv2/training/logging/nnunet_logger.py:9-118`):
fixed-key in-memory metric lists, EMA pseudo-dice (lambda=0.9), 3-panel
progress.png, checkpoint round-trip."""

from typing import Optional

import numpy as np


class TrainingLogger:
    def __init__(self, verbose: bool = False):
        self.my_fantastic_logging = {
            "mean_fg_dice": [],
            "ema_fg_dice": [],
            "dice_per_class_or_region": [],
            "train_losses": [],
            "val_losses": [],
            "lrs": [],
            "epoch_start_timestamps": [],
            "epoch_end_timestamps": [],
        }
        self.verbose = verbose

    def log(self, key: str, value, epoch: int) -> None:
        assert key in self.my_fantastic_logging, f"unknown logging key {key}"
        if self.verbose:
            print(f"logging {key}: {value} for epoch {epoch}")

        if key == "mean_fg_dice":
            new_ema = value if len(self.my_fantastic_logging["ema_fg_dice"]) == 0 \
                else self.my_fantastic_logging["ema_fg_dice"][epoch - 1] * 0.9 + 0.1 * value
            self.log("ema_fg_dice", new_ema, epoch)

        lst = self.my_fantastic_logging[key]
        if len(lst) < epoch + 1:
            lst.extend([None] * (epoch + 1 - len(lst)))
        lst[epoch] = value

    def plot_progress_png(self, output_folder: str) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        log = self.my_fantastic_logging
        epoch = min(len(log["train_losses"]), len(log["mean_fg_dice"]),
                    len(log["ema_fg_dice"]), len(log["val_losses"])) - 1
        if epoch < 0:
            return
        fig, axes = plt.subplots(3, 1, figsize=(10, 12))
        x = list(range(epoch + 1))
        ax = axes[0]
        ax.plot(x, log["train_losses"][:epoch + 1], label="loss_tr")
        ax.plot(x, log["val_losses"][:epoch + 1], label="loss_val")
        ax2 = ax.twinx()
        ax2.plot(x, log["mean_fg_dice"][:epoch + 1], color="g", label="pseudo dice")
        ax2.plot(x, log["ema_fg_dice"][:epoch + 1], color="b",
                 label="pseudo dice (EMA)")
        ax.set_xlabel("epoch")
        ax.legend(loc=2)
        ax2.legend(loc=4)

        if len(log["epoch_end_timestamps"]) > epoch and \
                len(log["epoch_start_timestamps"]) > epoch:
            durations = [e - s for s, e in zip(log["epoch_start_timestamps"][:epoch + 1],
                                               log["epoch_end_timestamps"][:epoch + 1])]
            axes[1].plot(x, durations)
            axes[1].set_ylabel("epoch duration [s]")

        axes[2].plot(x, log["lrs"][:epoch + 1])
        axes[2].set_ylabel("learning rate")
        axes[2].set_xlabel("epoch")
        fig.tight_layout()
        import os
        fig.savefig(os.path.join(output_folder, "progress.png"))
        plt.close(fig)

    def get_checkpoint(self) -> dict:
        return self.my_fantastic_logging

    def load_checkpoint(self, checkpoint: dict) -> None:
        self.my_fantastic_logging = checkpoint
