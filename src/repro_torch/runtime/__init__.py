"""Fault-tolerance runtime of the port: the names the serving stack uses
(`launch/autobatch.py`, `launch/serve.py`) — the straggler watchdog and
the bounded-retry wrapper."""
from .fault import StepWatchdog, StragglerReport, with_retries

__all__ = ["StepWatchdog", "StragglerReport", "with_retries"]
