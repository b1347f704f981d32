// K1's kernels for 2-bit groups (see dequant_kernels.cuh).
#include "dequant_kernels.cuh"

template cudaError_t claq::dispatch<2>(int, bool, dim3*, cudaStream_t,
                                         const claq::Args&, int*);
