"""PyTorch/CUDA port of cruise_control_tpu's proposal solve.

The JAX package `cruise_control_tpu` stays the reference; this package
mirrors its module paths (model/state.py, analyzer/kernels.py, ...) so
each counterpart is easy to find.  It imports torch and numpy only —
nothing of JAX and nothing of the JAX package.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see device.py).  The hot per-round functions that XLA
compiled on the TPU are hand-written CUDA kernels here (csrc/, bound
through ctypes by cuda_kernels.py); each keeps a plain PyTorch version
beside it, which is what a CPU tensor runs.
"""
