"""Checkpoints of the pipeline state and per-phase timing."""
