"""PyTorch/CUDA port of the ``repro`` serving stack, for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it (or JAX).  Module names mirror the reference so
each counterpart is easy to find:

* ``models/`` -- config, norms, RoPE, attention, SwiGLU, the dense
  decoder (prefill, paged decode step, multi-step decode dispatch);
* ``kernels/`` -- hand-written Hopper kernels (CUDA C++ in ``csrc/``,
  built with ``nvcc`` at first use) beside their plain PyTorch versions;
* ``serving/`` -- the paged continuous batcher ``ServeEngine``;
* ``convert.py`` -- reference parameters (as numpy) -> port modules;
* ``launch/serve.py`` -- the serving launcher.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain version.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
