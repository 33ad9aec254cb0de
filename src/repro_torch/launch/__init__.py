"""Process-group setup, meshes and the training entry point."""
