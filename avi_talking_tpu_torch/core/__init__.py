"""FLAME head model and its assets."""
