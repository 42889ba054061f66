"""Baselines the paper compares against (Table 1)."""
