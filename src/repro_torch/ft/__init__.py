from repro_torch.ft.faults import (RECOVERABLE, Fault, QueueFull,
                                   RejectedRequest, ResourceExhausted,
                                   RestartsExhausted, StepCrash)
