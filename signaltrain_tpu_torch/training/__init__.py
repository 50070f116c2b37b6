"""Checkpoint I/O in the reference's .tar schema."""
