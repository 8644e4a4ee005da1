"""Shape helpers shared by the port's schedulers."""

from .shapes import canon_dim, next_pow2

__all__ = ['canon_dim', 'next_pow2']
