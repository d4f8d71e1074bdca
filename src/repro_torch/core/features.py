"""Analytic complexity functions (the paper's ``c`` augmentation) that the
port's registry needs, copied from the JAX package's ``core.features``."""
from __future__ import annotations


def blur_complexity(p: dict) -> float:
    """3x3 box blur: nine additions per pixel of the [m, n] plane."""
    return float(p["m"] * p["n"] * 9)
