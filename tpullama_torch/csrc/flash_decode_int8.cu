// The int8-cache instances of flash_decode.cu (the TPU kernels'
// has_kv_scale branches, tpullama/ops/pallas/flash_decode.py:98, :116,
// :179, :198): the same kernel, built in a translation unit of its own so
// that nvcc compiles them beside the others (build.py starts one nvcc per
// source). Its design and its entry point, tpl_flash_decode, are in
// flash_decode.cu.

#define TPL_ATTN_INT8
#include "flash_decode.cu"
