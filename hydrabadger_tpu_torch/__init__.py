"""hydrabadger_tpu_torch — the PyTorch + CUDA port of hydrabadger_tpu.

A package of its own beside the JAX one, which stays the reference.  It
imports torch and numpy and nothing of JAX or of hydrabadger_tpu: what it
needs of the JAX-free host code it keeps as its own copy (crypto/,
consensus/, obs/, utils/, the sim's router and network).

    device.py            resolve_device: the card unless the caller asks for cpu
    utils/codec.py       the canonical message codec (pure Python)
    utils/lru.py         the digest-keyed LRU of the crypto caches
    utils/envflags.py    HYDRABADGER_RBC, resolved at the sim and the node
    utils/ids.py         node ids and addresses
    obs/                 the sans-io recorder, counters, gauges and histograms,
                         the per-transaction latency ledgers, structured
                         logging, the trace writers
    crypto/gf256.py      GF(2^8) tables and host matrix ops (numpy)
    crypto/rs.py         encode/decode matrices, numpy ReedSolomon (the oracle),
                         byte payloads in and out of shards
    crypto/bls12_381.py  G1 over Fp, G2 over Fp2, Fp12 and the pairing checks,
                         hash onto G2, encodings; native dispatch, the pure
                         `_py_*` bodies as the oracles
    crypto/native_bls.py ctypes binding of native/bls12_381.cpp (host C++, not a
                         kernel), built by g++ into build/host_native/
    crypto/threshold.py  keys, signatures, Shamir key sets, Lagrange, threshold
                         encryption, decryption and signature shares, their
                         verification and combines
    crypto/homhash.py    the low-comm broadcast's shard sketches (host)
    crypto/futures.py    CryptoFuture: fetch once, warn and remember when dropped
    crypto/engine.py     CpuEngine, GpuEngine and their registry
    consensus/           the sans-io cores: Broadcast (bracha, lowcomm),
                         BinaryAgreement, ThresholdSign, Subset,
                         ThresholdDecrypt, HoneyBadger, QueueingHoneyBadger
    csrc/                hand-written CUDA sources for sm_90a (H100)
    ops/_kernels.py      nvcc build into build/torch_kernels/, ctypes binding
    ops/gf256_torch      GF(2^8) matmul: the kernel and its plain version
    ops/rs_torch         batched RS encode / reconstruct
    ops/homhash_torch    the shard sketches on the GF(2^8) kernel
    ops/limbs.py         the Fp and G2 limb layouts and host conversions
    ops/fq_torch         Fp and Jacobian G1 ops: kernel B2 and its plain version
    ops/bls_torch        batched G1 ladders: decryption shares, Lagrange combines
    ops/fp12_circuit     the circuit recorder (numpy)
    ops/circuit_torch    recorded circuits: kernel B3 and its plain version
    ops/decrypt_torch    the fused threshold-decrypt epoch (config 8)
    ops/fq2_torch        Fp2 and Jacobian G2 ops: kernel B4 and its plain version
    ops/bls_g2_torch     batched G2 ladders: sign shares, Lagrange combines
    ops/fp_probe_torch   the Fp probes' kernel and its plain versions
    ops/ntt_torch        the GF(2^8) additive FFT's plan and numpy twins, the
                         Fr NTT's names
    ops/afft_torch       the additive FFT as torch ops on the tensor's device
    ops/rs_fft           RS by interpolate-and-evaluate (the FFT route)
    sim/tensor.py        the fast-path epoch (TensorSim) and the
                         threshold-decrypt plane (FullCryptoTensorSim: the
                         decrypt engine or the generic epoch)
    parallel/mesh.py     the tensor planes over a device mesh: one SPMD rank per
                         device under torch.distributed (NCCL on cards, gloo on
                         the CPU), the rank launcher
    sim/coin.py          one common-coin round for every ABA instance
                         (CoinRound) through GpuEngine
    sim/decrypt.py       one epoch's threshold decryption (DecryptRound)
                         through GpuEngine
    sim/router.py        the deterministic message router
    sim/network.py       SimNetwork: QueueingHoneyBadger nodes over the router
                         (python -m hydrabadger_tpu_torch.sim is its CLI)
    net/                 the TCP node tier: signed frames (wire), peers, the
                         node (Config, Hydrabadger), the CryptoBridge batcher
    __main__.py          the node CLI: python -m hydrabadger_tpu_torch
    blockchain.py        the reference's toy proof-of-work chain (--mine)
    experiments/         the Fp probes E1-E4 (python -m ..., on a card)

Importing builds nothing and touches no card; kernels build at their
first launch on a CUDA tensor, the native host library at its first call.
"""
