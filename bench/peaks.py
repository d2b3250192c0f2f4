"""Peak rates of one NVIDIA H100 SXM5 80 GB (the card reports itself as
"NVIDIA H100 80GB HBM3"), dense, at its 700 W limit.

Published (NVIDIA H100 Tensor Core GPU datasheet):
  * BF16 tensor-core 989.4 TFLOP/s; TF32 494.7; FP32 (CUDA cores) 66.9;
  * HBM3 3.35 TB/s.
Derived, not on the datasheet:
  * INT32: 132 SMs x 64 INT32 lanes a clock (the Hopper SM's four
    partitions issue 16 INT32 operations each a clock, half its 128 FP32
    lanes; the whitepaper's SM diagram) x 1.98 GHz boost = 16.73 Tops/s.
A roofline share is stated against these with the card's power limit
beside it; a card set below 700 W reads lower.

One hash draw of the fault model (``reference/fault.py``) needs 15
integer operations: the index plus the plane's constant (1), three
xor-shifts (2 each), four multiplies, the xor with the (folded) seed and
the final xor-shift (2), and the compare with the rate's threshold (1):
the two lowbias32 rounds with the inner round's last xor-shift merged into
the outer's first (``h ^ s ^ ((h ^ s) >> 16)`` is ``v ^ s ^ (s >> 16)``
for ``h = v ^ (v >> 16)``).  One count serves every kernel: a kernel that
spends more (the 20-operation form) reads a lower share.
"""
BF16_FLOPS = 989.4e12
TF32_FLOPS = 494.7e12
FP32_FLOPS = 66.9e12
INT32_OPS = 132 * 64 * 1.98e9
HBM_BYTES = 3.35e12
HASH_OPS_PER_DRAW = 15

# a configuration's dtype -> the peak its model FLOPs are held to
DTYPE_FLOPS = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}
