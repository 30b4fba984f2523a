// Kernel A's forward (flash_attn_fwd.cuh) at head_dim 64 (GPT-2) and 80
// (zamba2's shared attention).
#define FLASH_FWD_HEAD_DIMS(X) X(64) X(80)
#include "flash_attn_fwd.cuh"
