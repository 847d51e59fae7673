"""The port's Fp probes: what a one-thread-per-lane Montgomery product costs
on the card.  Counterparts of the Pallas prototypes in experiments/ at the
repository root, each on the `fp_probe` kernel (csrc/fp_probe.cu,
ops/fp_probe_torch):

    cuda_fq            E1 (experiments/pallas_fq.py): ns per Fp product of a
                       standalone product kernel, by threads per block
    prof_mul_variants  E2: the product's parts chained inside one kernel
                       (full CIOS, the FP64-schoolbook form, the unreduced
                       schoolbook, the carry)
    prof_mix_vs_mul    E3: a circuit's multiply layer alone against kernel
                       B3's `add` circuit, per product
    prof_fixed_cost    E4: the fixed cost of a launch, queued from the host
                       and replayed as one CUDA graph, and `x + 1` in PyTorch

Each runs on the card, `python -m hydrabadger_tpu_torch.experiments.<probe>`,
and prints one JSON line per measurement.  `--device` defaults to cuda and
raises without a card: a probe measures the card or nothing.
"""
