"""Bridges to other implementations (the reference tree)."""
