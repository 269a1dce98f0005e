"""leetcuda_tpu_torch — the PyTorch/CUDA port of ``leetcuda_tpu``.

Mirrors the JAX package's layout (``core/``, ``attention/``, ``ops/``,
``models/``, ``engine/``). Plain tensor code is PyTorch; every Pallas kernel
on a ported path is a CUDA C++ kernel written by hand for Hopper (``sm_90a``)
under ``csrc/``, built by ``build.py`` at first use.

Importing the package builds nothing and needs no GPU: a kernel is compiled
the first time its wrapper sees a CUDA tensor. On CPU tensors each wrapper
runs its plain PyTorch version.
"""
