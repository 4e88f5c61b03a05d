from repro_torch.ft.checkpoint import (CheckpointManager, latest_step,
                                       restore, save, sweep_stale_tmp)
from repro_torch.ft.faults import (RECOVERABLE, Fault, QueueFull,
                                   RejectedRequest, ResourceExhausted,
                                   RestartsExhausted, StepCrash)
from repro_torch.ft.injection import FaultInjector, FaultPlan
from repro_torch.ft.manager import (ServeSupervisor, StragglerWatchdog,
                                    run_with_restarts)
