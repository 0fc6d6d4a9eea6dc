"""nldsc-jax: LD-score + heritability framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``bayarpark/nldsc``:

* ``estimate_lds``  — additive (L2) and dominance (L2D) LD scores from PLINK
  ``.bed/.bim/.fam``, computed as banded block-correlation matmuls on a GPU
  (reference semantics: ``nldsc/ldscore/_ldscore/ldscalc.h``).
* ``estimate_h2``   — additive + dominance heritability via IRWLS LD-score
  regression with block-jackknife SEs (reference semantics:
  ``nldsc/h2/regressions.py``).
"""

from .core.compile_cache import enable_persistent_cache

# On-disk XLA compilation cache, on by default (NLDSC_NO_COMPILE_CACHE=1
# opts out); see core/compile_cache.py for where it lives.
enable_persistent_cache()

from .version import __version__
from .ld.pipeline import estimate_lds
from .h2.pipeline import estimate_h2

__all__ = ["estimate_lds", "estimate_h2", "__version__"]
