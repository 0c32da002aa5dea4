// Flash attention's DP = 128 instances (the kernels of flash_attention.cu at
// that padded d_head), in a translation unit of their own so that nvcc
// builds each width at once; flash_attention.cu's entry points reach them
// through repro_flash::launches_dp128.
#define REPRO_FLASH_DP 128
#include "flash_attention.cu"
