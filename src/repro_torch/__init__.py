"""PyTorch + CUDA port of the CLAQ serving stack (the JAX package ``repro``
is the reference it is held against).  Imports no JAX and nothing of
``repro``; kernels build at first CUDA use, never at import."""
