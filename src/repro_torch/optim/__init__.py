from repro_torch.optim import adamw
from repro_torch.optim.schedule import Schedule
