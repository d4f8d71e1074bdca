"""Predictors (NN+C) and the kernel-DAG scheduler."""
