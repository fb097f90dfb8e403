"""pydnmfk_tpu — distributed NMF with automatic model selection, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of lanl/pyDNMFk:
distributed non-negative matrix factorization (Frobenius / KL; MU / HALS /
BCD) over a 2D device mesh, NNSVD initialization, zero-row/column pruning,
checkpoint/restart, and the NMFk perturbation-ensemble pipeline with
custom-clustering silhouette + Wilcoxon selection of the latent dimension k.
"""

from .config import NMFConfig, NMFkConfig
from .parallel.mesh import GridContext, grid_context, make_grid_mesh
from .models.nmf import NMF
from .models.nmfk import NMFk
from .runner import Runner

__version__ = "0.5.0"

__all__ = [
    "NMFConfig", "NMFkConfig", "GridContext", "grid_context",
    "make_grid_mesh", "NMF", "NMFk", "Runner", "__version__",
]
