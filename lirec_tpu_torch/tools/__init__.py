"""Measurement scripts for the card (tools/profile_train.py)."""
