// Flash attention's DP = 256 instances (the kernels of flash_attention.cu at
// that padded d_head), in a translation unit of their own so that nvcc
// builds each width at once; flash_attention.cu's entry points reach them
// through repro_flash::launches_dp256.
#define REPRO_FLASH_DP 256
#include "flash_attention.cu"
