"""Masked optimizers and learning-rate schedules (the port of ``repro.optim``)."""
