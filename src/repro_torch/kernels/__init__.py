"""The dequant-GEMM kernel (K1), its inference plans and its dispatch."""
