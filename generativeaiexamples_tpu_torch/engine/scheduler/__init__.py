"""Scheduler policies of the port's engine: ``base`` (the seam, wave
formation and ``build_policy``), ``unified`` (the default single tier),
``disagg`` (a prefill tier and a decode tier over one page pool) and
``handoff`` (the record and the bounded queue between them)."""
