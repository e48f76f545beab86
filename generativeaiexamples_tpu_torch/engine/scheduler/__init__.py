"""Scheduler policies of the port's engine (``unified`` only so far)."""
