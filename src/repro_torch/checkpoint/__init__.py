"""Checkpoint save/restore with async writes and retention."""
