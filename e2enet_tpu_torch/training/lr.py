"""Learning-rate and momentum schedules: the port of
e2enet_tpu/training/lr.py, plain Python that equals it to the bit.

Reference e2enet/training/learning_rate/poly_lr.py (poly_lr), the
per-epoch update in nnUNetTrainer_simple.maybe_update_lr (:756-771), and
the optimizer_and_lr variant-trainer schedules
(training/network_training/nnUNet_variants/optimizer_and_lr/):
  - nnUNetTrainerV2_warmup.py:19-39 (50-epoch linear warmup, then poly)
  - nnUNetTrainerV2_SGD_fixedSchedule.py:19-44 (step schedule)
  - nnUNetTrainerV2_SGD_fixedSchedule2.py:21-47 (one step, then poly)
  - nnUNetTrainerV2_cycleAtEnd.py:22-63 (poly to 1000, then triangle cycle)
  - torch ReduceLROnPlateau as configured in nnUNetTrainer.py:124-125,
    :271-274 (mode min, factor 0.2, patience 30, threshold 1e-3) and
    stepped on train_loss_MA (network_trainer.py:515-517).
"""


def poly_lr(epoch: int, max_epochs: int, initial_lr: float,
            exponent: float = 0.9) -> float:
    return initial_lr * (1 - epoch / max_epochs) ** exponent


def warmup_poly_lr(epoch: int, max_epochs: int, initial_lr: float,
                   warmup_epochs: int = 50) -> float:
    """nnUNetTrainerV2_warmup.maybe_update_lr: linear 0 -> initial_lr over
    the first `warmup_epochs`, then poly on (epoch - warmup + 1)."""
    if epoch < warmup_epochs:
        return (epoch + 1) / warmup_epochs * initial_lr
    return poly_lr(epoch - (warmup_epochs - 1), max_epochs, initial_lr, 0.9)


def fixed_schedule_lr(epoch: int, initial_lr: float) -> float:
    """nnUNetTrainerV2_SGD_fixedSchedule: x1 / x0.1 / x0.01 / x0.001 at
    epochs 500 / 675 / 850."""
    if epoch < 500:
        return initial_lr
    if epoch < 675:
        return initial_lr * 0.1
    if epoch < 850:
        return initial_lr * 0.01
    return initial_lr * 0.001


def fixed_schedule2_lr(epoch: int, max_epochs: int,
                       initial_lr: float) -> float:
    """nnUNetTrainerV2_SGD_fixedSchedule2: one x0.1 step at 500, then poly
    from epoch 675 at initial_lr*0.1."""
    if epoch < 500:
        return initial_lr
    if epoch < 675:
        return initial_lr * 0.1
    return poly_lr(epoch - 675, max_epochs - 675, initial_lr * 0.1, 0.9)


def cycle_lr(epoch: int, cycle_length: int = 100, min_lr: float = 1e-6,
             max_lr: float = 1e-3) -> float:
    """Triangle cycle (nnUNetTrainerV2_cycleAtEnd.cycle_lr:22-29)."""
    num_rising = cycle_length // 2
    e = epoch % cycle_length
    if e < num_rising:
        return min_lr + (max_lr - min_lr) / num_rising * e
    return max_lr - (max_lr - min_lr) / num_rising * (e - num_rising)


def cycle_at_end_lr(epoch: int, initial_lr: float) -> float:
    """nnUNetTrainerV2_cycleAtEnd.maybe_update_lr: poly over the first
    1000 epochs, then the triangle cycle (max epochs 1100)."""
    if epoch < 1000:
        return poly_lr(epoch, 1000, initial_lr, 0.9)
    return cycle_lr(epoch, 100, min_lr=1e-6, max_lr=1e-3)


def reduce_momentum(epoch: int, base: float = 0.99,
                    min_momentum: float = 0.9) -> float:
    """nnUNetTrainerV2_reduceMomentumDuringTraining: after epoch 800,
    linearly decrease momentum from 0.99 to 0.9 over 200 epochs."""
    if epoch <= 800:
        return base
    return max(min_momentum,
               base - (base - min_momentum) / 200 * (epoch - 800))


def ce_to_dice_weights(epoch: int, max_epochs: int):
    """nnUNetTrainerV2_graduallyTransitionFromCEToDice.update_loss: CE-only
    for 500 epochs, linear CE->Dice transition to 750, Dice-only after.
    Returns (weight_ce, weight_dice)."""
    if epoch <= 500:
        return 2.0, 0.0
    if epoch <= 750:
        w = 2.0 / 250 * (epoch - 500)
        return 2.0 - w, w
    return 0.0, 2.0


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold_mode='rel') as configured by nnUNetTrainer (factor 0.2,
    patience 30, threshold 1e-3). step(metric) returns the new lr."""

    def __init__(self, initial_lr: float, factor: float = 0.2,
                 patience: int = 30, threshold: float = 1e-3,
                 min_lr: float = 0.0):
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def state_dict(self):
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, sd):
        self.lr = sd["lr"]
        self.best = sd["best"]
        self.num_bad_epochs = sd["num_bad_epochs"]

    def step(self, metric: float) -> float:
        # rel threshold, mode min: better if metric < best * (1 - thr)
        if metric < self.best * (1.0 - self.threshold) or \
                (self.best == float("inf")):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr
