"""Checkpoints of scenes and env states, and profiling helpers."""
