"""Kernel-study entry points: ``exp_tap9`` (T1, T2) and ``exp_cmajor`` (T3)."""
