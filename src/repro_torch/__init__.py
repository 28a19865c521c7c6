"""STRADS on PyTorch and CUDA: the port of the JAX package ``repro``.

The subpackages mirror the JAX package's (``core``, ``sched``, ``part``,
``obs``, ``kernels``, ``apps``, and for the model zoo ``configs``,
``sharding``, ``models``, ``data``, ``train``, ``launch``) so every
module has one obvious counterpart.  The port imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""
