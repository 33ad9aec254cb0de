"""Serving step functions (the training steps come with ROADMAP.md, Queue 1 item 5)."""
