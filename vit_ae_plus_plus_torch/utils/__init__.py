"""Helpers without torch: NIfTI I/O."""
