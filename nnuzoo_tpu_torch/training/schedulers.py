"""Learning-rate schedules (port of ``nnuzoo_tpu/training/schedulers.py`` and
of ``cosine_annealing`` in ``nnuzoo_tpu/training/trainer.py``).

Each is a plain Python function of the *epoch* (a number) that returns the
learning rate as a float; the rate is constant within an epoch.
:func:`per_step` adapts one to a count of optimizer steps; the Trainer sets
the optimizer's rate from it before every step.
"""

import math
from typing import Callable


def poly_lr(initial_lr: float, max_epochs: int, exponent: float = 0.9) -> Callable:
    """lr = initial * (1 - epoch/max)^0.9."""
    def schedule(epoch):
        return initial_lr * (1 - min(epoch, max_epochs - 1) / max_epochs) ** exponent
    return schedule


def poly_lr_with_warmup(initial_lr: float, max_epochs: int, warmup_epochs: int,
                        exponent: float = 0.9, warmup_initial_factor: float = 1e-3
                        ) -> Callable:
    """Linear warmup, then poly decay."""
    def schedule(epoch):
        if epoch < warmup_epochs:
            return initial_lr * (warmup_initial_factor +
                                 (1 - warmup_initial_factor) *
                                 min(epoch, warmup_epochs) / max(warmup_epochs, 1))
        decay_epoch = max(epoch - warmup_epochs, 0)
        decay_total = max(max_epochs - warmup_epochs, 1)
        return initial_lr * (1 - min(decay_epoch, decay_total - 1)
                             / decay_total) ** exponent
    return schedule


def linear_warmup_cosine_annealing(initial_lr: float, max_epochs: int,
                                   warmup_epochs: int, warmup_start_lr: float = 0.0,
                                   eta_min: float = 0.0) -> Callable:
    def schedule(epoch):
        if epoch < warmup_epochs and warmup_epochs > 0:
            return warmup_start_lr + (initial_lr - warmup_start_lr) * \
                epoch / max(warmup_epochs - 1, 1)
        t = (epoch - warmup_epochs) / max(max_epochs - warmup_epochs, 1)
        return eta_min + (initial_lr - eta_min) * (1 + math.cos(math.pi * t)) / 2
    return schedule


def lin_incr_lr(initial_lr: float, max_epochs: int) -> Callable:
    def schedule(epoch):
        return initial_lr * (epoch + 1) / max_epochs
    return schedule


def cosine_annealing(initial_lr: float, max_epochs: int, eta_min: float) -> Callable:
    def schedule(epoch):
        t = min(epoch, max_epochs) / max_epochs
        return eta_min + (initial_lr - eta_min) * (1 + math.cos(math.pi * t)) / 2
    return schedule


def per_step(epoch_schedule: Callable, steps_per_epoch: int) -> Callable:
    """Adapt an epoch -> lr schedule to a count of optimizer steps."""
    def schedule(step):
        return epoch_schedule(step // steps_per_epoch)
    return schedule


def continued_poly_lr_with_warmup(initial_lr: float, total_epochs: int,
                                  warmup_epochs: int, start_epoch: int = 0,
                                  warmup_lr: float = 1e-5, final_lr: float = 1e-5,
                                  exponent: float = 0.9) -> Callable:
    """Linear warmup from ``warmup_lr`` over ``warmup_epochs`` starting at
    ``start_epoch``, then poly decay to ``final_lr`` at ``total_epochs``."""
    def schedule(epoch):
        if epoch < warmup_epochs + start_epoch:
            return warmup_lr + (initial_lr - warmup_lr) * (
                max(epoch - start_epoch, 0) / max(warmup_epochs, 1))
        decay_steps = max(total_epochs - start_epoch - warmup_epochs, 1)
        adjusted = epoch - start_epoch - warmup_epochs
        return final_lr + (initial_lr - final_lr) * (
            1 - min(max(adjusted, 0), decay_steps) / decay_steps) ** exponent
    return schedule


def finetune_double_warmup_lr(initial_lr: float, num_epochs: int,
                              freeze_encoder_epochs: int,
                              encoder_warmup_epochs: int,
                              decoder_warmup_epochs: int) -> Callable:
    """Two phases: while the encoder is frozen, a continued poly schedule over
    [0, freeze) with the encoder warmup; afterwards a fresh one starting at
    ``freeze_encoder_epochs`` with the decoder warmup over the full run."""
    phase1 = continued_poly_lr_with_warmup(
        initial_lr, total_epochs=freeze_encoder_epochs,
        warmup_epochs=encoder_warmup_epochs, start_epoch=0)
    phase2 = continued_poly_lr_with_warmup(
        initial_lr, total_epochs=num_epochs,
        warmup_epochs=decoder_warmup_epochs, start_epoch=freeze_encoder_epochs)

    def schedule(epoch):
        return phase1(epoch) if epoch < freeze_encoder_epochs else phase2(epoch)
    return schedule
