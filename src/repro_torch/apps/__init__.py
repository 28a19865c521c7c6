"""STRADS applications on the port: the paper's Lasso, MF and LDA."""
from . import lasso, lda, mf

__all__ = ["lasso", "lda", "mf"]
