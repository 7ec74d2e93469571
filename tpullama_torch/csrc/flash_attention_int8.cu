// The int8-cache instances of flash_attention.cu (the TPU kernel's
// has_kv_scale branches, tpullama/ops/pallas/flash_attention.py:85-86 and
// :106-108): the same kernel, built in a translation unit of its own so that
// nvcc compiles them beside the others (build.py starts one nvcc per source).
// Its design and its entry point, tpl_flash_attention, are in
// flash_attention.cu.

#define TPL_ATTN_INT8
#include "flash_attention.cu"
