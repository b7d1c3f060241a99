"""Learning-rate schedule: a copy of poly_lr of e2enet_tpu/training/lr.py
(reference e2enet/training/learning_rate/poly_lr.py)."""


def poly_lr(epoch: int, max_epochs: int, initial_lr: float,
            exponent: float = 0.9) -> float:
    return initial_lr * (1 - epoch / max_epochs) ** exponent
