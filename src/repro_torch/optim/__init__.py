"""Masked optimizers, learning-rate schedules and error-feedback gradient
compression (the port of ``repro.optim``)."""
