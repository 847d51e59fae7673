"""hydrabadger_tpu_torch — the PyTorch + CUDA port of hydrabadger_tpu.

A package of its own beside the JAX one, which stays the reference.  It
imports torch and numpy and nothing of JAX or of hydrabadger_tpu: what it
needs of the JAX-free host code it keeps as its own copy (crypto/).

    device.py        resolve_device: the card unless the caller asks for cpu
    crypto/gf256.py  GF(2^8) tables and host matrix ops (numpy)
    crypto/rs.py     encode/decode matrices, numpy ReedSolomon (the oracle)
    csrc/            hand-written CUDA sources for sm_90a (H100)
    ops/_kernels.py  nvcc build into build/torch_kernels/, ctypes binding
    ops/gf256_torch  GF(2^8) matmul: the kernel and its plain version
    ops/rs_torch     batched RS encode / reconstruct
    sim/tensor.py    the fault-free fast-path epoch (TensorSim)

Importing builds nothing and touches no card; kernels build at their
first launch on a CUDA tensor.
"""
