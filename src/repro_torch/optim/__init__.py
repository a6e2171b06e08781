from repro_torch.optim.adamw import AdamW
from repro_torch.optim.sgd import SGD
from repro_torch.optim import schedules

__all__ = ["AdamW", "SGD", "schedules"]
