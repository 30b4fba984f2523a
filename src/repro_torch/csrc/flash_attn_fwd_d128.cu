// Kernel A's forward (flash_attn_fwd.cuh) at head_dim 128 (llama3.2-3b,
// phi3.5-MoE), in a library of its own so that nvcc compiles it beside
// the other head dims, not after them.
#define FLASH_FWD_HEAD_DIMS(X) X(128)
#include "flash_attn_fwd.cuh"
