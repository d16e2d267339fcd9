"""Pay the kernels' build once, at startup.

Port of counterfactualworldmodels_tpu/utils/cache.py. The JAX package
points XLA's persistent compilation cache at a directory; the port compiles
nothing at run time except its hand-written kernels, which ``kernels``
builds once per source hash into its build directory. So
``enable_persistent_cache`` builds them there now (a server pays nvcc
before its first request, not on it), optionally in another directory.
Unlike the JAX version it swallows nothing: a failed build raises.
"""
from __future__ import annotations

from typing import Optional

from .. import kernels


def enable_persistent_cache(build_dir: Optional[str] = None):
    """Build every kernel library that is not built yet (in ``build_dir``
    when given, which then holds the libraries ``kernels.load`` finds;
    the library names still hash only the sources and flags). Returns
    kernels.build()'s {name: ptxas report} of what it built."""
    if build_dir is not None:
        kernels.set_build_dir(build_dir)
    return kernels.build()
