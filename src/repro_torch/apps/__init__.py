"""STRADS applications on the port (Lasso first; MF and LDA follow in
ROADMAP.md queue 1, step 8)."""
from . import lasso

__all__ = ["lasso"]
