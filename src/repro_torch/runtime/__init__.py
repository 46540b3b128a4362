"""Fault-tolerance runtime of the port: the straggler watchdog and the
bounded-retry wrapper (the serving stack, `launch/autobatch.py` and
`launch/serve.py`, and the trainer) and the trainer's preemption
handler."""
from .fault import (PreemptionHandler, StepWatchdog, StragglerReport,
                    with_retries)

__all__ = ["PreemptionHandler", "StepWatchdog", "StragglerReport",
           "with_retries"]
