"""The stage-based lifecycle API (serving stage in this slice)."""

from repro_torch.pipeline.session import ServeHandle, Session
