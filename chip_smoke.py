#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

    python3 chip_smoke.py

Runs from the root of a checkout (it imports `hydrabadger_tpu_torch` from
beside itself) and needs one CUDA card with nvcc.  Phases, each fatal on
failure:

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel from csrc/ (one nvcc per source, in parallel) and,
     beside them, the four host libraries (utils/host_native: g++ of
     native/bls12_381.cpp, gf256_rs.cpp and acs_engine.cpp, gcc of the
     codec's C twin native/hb_codec.c; host code, not kernels; each build's
     seconds printed): each kernel's registers and spills (ptxas), and B1's
     matrix instructions in its SASS (cuobjdump);
  3. kernel B1 (gf256_matmul, the bit product on the int8 tensor cores)
     against its plain PyTorch version on the card, exact bytes, at the
     main path's shapes (the encode into the codeword's parity rows, the
     reconstruct from the parity-quorum view), an unaligned view, a ragged
     one, the 4-node engine shape (2, 2), several launches over row chunks
     (233, 22) and many K tiles (32, 223), and against the numpy GF(2^8)
     reference on sampled instances; then rs64-batch64k's two launches (64
     rows of 11,637 bytes: the encode into the codeword's parity rows, the
     reconstruct from the quorum view 42 * L bytes into each row), each
     one launch on B1's row path, with nothing outside the parity rows
     written;
  4. the main path: TensorSim at the config-6 geometry (64 nodes x 1024
     instances, 12-byte shards), 50 epochs with every launch counter set
     to 0 just before and read just after; the verdict, 2 launches per
     epoch, all on B1's word path, the final state against the same epochs
     through the plain version, and one epoch of sampled instances against
     the host oracle; then 20 epochs at rs64-batch64k's geometry (one
     network, 11,637-byte shards): 2 launches an epoch, all on the row
     path, and the final state against the plain version's;
  5. timings: epochs/s, B1's time per launch at the epoch's two shapes
     (cold L2, median of 20) against its bound (ops/roofline.gf_matmul_ms),
     the ratio, the earlier SWAR kernel's time, its plain version and a bf16
     torch.matmul yardstick;
  6. the threshold-decrypt set-up: FullCryptoTensorSim at the config-8
     geometry (64 nodes x 64 instances = 4096 ciphertexts, t = 21): the
     key set and one host G1 multiply per ciphertext;
  7. kernel B2 (fq_point) against its plain version, exact: every point
     entry (mul, dbl, add, ladd, dblk4, win6) at 4096 lanes and at a ragged
     1013, with infinity, P + P and P + (-P) lanes, the main path's wider
     shapes, and the two ladders at the decrypt round's shapes
     (`glv_ladder` x 4096, `windowed_ladder` x 1408) and a ragged 1013,
     with scalar-0, 1 and r - 1 lanes;
  8. kernel B3 (circuit) against its plain version, exact: the three
     decrypt circuits at 94,208 (23 ladders x 4096), 4096 and a ragged
     1013 lanes, the signed-mix regression vector, and the Straus chain
     entry at 4096 lanes against its plain loop and against a loop of
     single-circuit launches, byte for byte;
  9. the main path: one warm-up epoch, held byte for byte against the same
     epoch through the plain versions on the card; then 3 epochs with every
     launch counter set to 0 just before and read just after: the verdict,
     the launch counts the static digits imply (B3: 21 + 22 circuit
     launches and one chain launch per epoch at 64 x 64), and sampled
     lanes against the host oracle;
 10. timings: epochs/s; each B2 entry's and B3 launch shape's device time
     per launch at the main path's shapes and operand forms, the chain
     included (CUDA events over back-to-back launches, median), its plain
     version, its bound and what sets it;
 11. kernel B4 (fq2_point) against its plain version, exact: `table`,
     `step` and `add` at 4096 and at a ragged 1013 lanes with an infinity
     lane, a digit-0 lane, acc == sel, acc == -sel and a scalar-0 lane,
     at the coin round's 1408-lane (and tree) shapes, and `ladder` at
     4096, 1408 and 1013 lanes with scalar-0, 1 and r - 1 lanes;
 12. the main path: CoinRound at 64 nodes x 64 instances (set-up: the key
     set, 22 host G1 multiplies, 64 host hashes onto G2); a warm-up round;
     the round's device results held limb for limb against the same round
     through the plain versions on the card; a counted round, every launch
     counter set to 0 just before and read just after: B4's launches by
     entry equal to the plan from the digits (7: a ladder to sign, a
     ladder and 5 tree adds to combine); sampled shares and all 64
     combined signatures against the host oracle; the 64 coin bits;
 13. timings: each B4 launch shape's device time at the main path's
     operands against its bound from the round's digits and its plain
     version, and the `table` and `step` entries kept beside the ladder;
     shares/s and combines/s, device-only (CUDA events) and wall; coin
     rounds/s;
 14. the Fp probe kernel (fp_probe) against its plain version, exact:
     `mul` at E1's 65,536 lanes for every block width, `chain` with each of
     its four bodies at E2's 8192 and the decrypt path's 4096 and 94,208
     lanes, `mul_layer` at E3's [12, 2 x 18,432], `noop` at E4's [32, 1024],
     each also at a ragged 1013;
 15. the probes E1-E4 through their modules' entry points
     (hydrabadger_tpu_torch/experiments/), every fp_probe counter set to 0
     just before and read just after: each entry launched; their timings
     beside their bounds (E1 by block width, E2's bodies at three lane
     counts, E3 against B3's `add` circuit per product, E4 queued, back to
     back, as a CUDA graph and `x + 1` in PyTorch);
 16. the main path: DecryptRound at 64 nodes (set-up: the key set, 22 host
     G1 multiplies, 64 host encryptions); a warm-up round; the round's 4096
     shares and 64 combined points held limb for limb against the same
     round through the plain versions on the card; a counted round, every
     launch counter set to 0 just before and read just after: kernel B2's
     launches by entry equal to the plan from the digits (7: `glv_ladder`,
     `windowed_ladder` and 5 tree adds), no other kernel;
     sampled shares and all 64 combined points against the host oracle and
     all 64 plaintexts against the contributions encrypted; timings: device
     ms by events, wall ms, the bound from the round's digits.

 17. kernel B1 at the low-comm broadcast's sketch shapes, exact against its
     plain version and crypto/homhash: m = 8, K in {1, 5, 97, 257, 300}
     (one launch, row chunks, K chunks), 1, 4, 16 and 64 columns, from a
     contiguous copy and a strided view; K = 0 gives zeros with no launch;
 18. the main path: the QueueingHoneyBadger simulator at config 2 (16
     nodes, `rbc_variant="lowcomm"`) for 3 epochs on `GpuEngine` against
     the host engine: every node's batches byte-identical, equal messages,
     transactions and faults; every launch counter set to 0 just before
     and read just after: B1's launches equal to those the sketch calls
     imply, no other kernel; epochs/s of both engines in turns, B1 launches and
     device ms (events) per epoch, host ms in operand builds, the bound;
 19. config 2 with the reference broadcast ("bracha"): the same checks,
     and 0 launches (no device call on that path);
 20. the full crypto tier at 4 nodes x 2 epochs (threshold encryption,
     the threshold coin, shares verified, lowcomm): batches byte-identical
     across the engines;
 21. the DKG's MSM plane (ops/msm_torch on kernel B2) against its plain
     version, exact, and sampled jobs against the host sum: identity lanes
     (infinity points, zero scalars, an empty job), a batch of one, the GLV
     tier, and row checks of the 16-node set (15 and 225 jobs of t + 1 = 6
     terms, 64-bit scalars);
 22. the commitment folds (ops/vandermonde_torch on B2) against their plain
     version, exact, and against the host fold: (J, K, M, nbits) =
     (6, 6, 16, 5) and the switch's (5, 5, 15, 4) with infinity entries,
     and the chain's collision x * acc == C[j];
 23. the main path: config 5's Python-core leg, the DynamicHoneyBadger era
     switch at 16 nodes (seed 7, 4 x 2-byte txns per node, a removal vote
     for the last node, a DKG among the 15 survivors, two steady epochs),
     on `GpuEngine` with the DKG's device plane forced against the host
     engine, in turns, the process-wide DKG caches cleared before each run:
     every node's batches, eras, key sets, validators, messages and faults
     byte-identical; every launch counter set to 0 just before the counted
     card run and read just after: B2's launches by entry (windowed and GLV
     ladders, add, dbl, ladd) all > 0 and equal to the MSMs', folds' and
     channel keys' own counts, no other kernel; the MSM jobs, real and
     padding lanes, the coalescer's flushes and width, host ms in
     limbs_to_points, wall s per epoch of both engines; every recorded
     shape held exact against its plain version (the channel-key batches
     side by side in one launch, each batch's own launch against its
     lanes of it) and replayed back to back for its device ms, beside its
     bound.
 24. the native host library (crypto/native_bls) against the pure-Python
     `_py_*` oracles: multiply and mul_sub on G1 and G2 (k = 0, 1, r - 1,
     random), add (P + Q, P + P, P - P, infinity), the weighted sum, the
     MSM, the fold, decompression, the subgroup checks, both pairing checks
     and hash_to_g2;
 25. kernel B2's `glv_ladder` at verify_batch's shapes (2, 3, 8, 50 and a
     ragged 1013 lanes of 128-bit coefficients) exact against its plain
     version and native g1_mul_batch; verify_batch on the card against the
     host engine (13 frames, one forged, one duplicate);
 26. the main path: config 1, the 4-node TCP testnet at full crypto
     (`Config(txn_gen_interval_ms=300, keygen_peer_count=3)`, seeds
     1000 + i, bench.py's generator) until every node commits 2 batches
     (wall cap 300 s), on `GpuEngine` with the DKG's device plane forced
     and on the host engine, in turns (cpu, gpu, gpu, cpu; a warm-up run
     first): agreement on every node, every contribution decrypted to the
     generator's transactions; every launch counter set to 0 just before
     the counted card run and read just after: every verify_batch call that
     reached the card replayed on the host engine with equal verdicts,
     every r_i * pk_i from B2 equal to native g1_mul_batch, B2's launches
     by entry equal to the verify batches plus the DKG plane's own counts,
     no other kernel; the verify lane histogram, host ms in
     limbs_to_points, wall epochs/s of both engines, and B2's device ms per
     run (every recorded shape held exact and timed back to back, times
     its count) beside its bound; then the fast tier with the low-comm
     broadcast on `GpuEngine` (4 nodes, 2 batches): B1's launches equal to
     those its sketch calls imply, no other kernel.
 27. the pairing plane at config 7's geometry (bench.py:705-760:
     random.Random(7), a t = 1 key set, 1024 ciphertexts, shares from key
     i % 2): every pairing circuit (ops/pairing_torch) on kernel B3 exact
     against its plain version at a ragged 1013 and at 2048 lanes with
     edge values; the main path, `GpuEngine.verify_decryption_share_pairs`
     on the 1024 shares plus 8 forged lanes and one at infinity, every
     launch counter set to 0 just before and read just after: B3's
     launches by circuit equal to `pairing_torch.schedule`, no other
     kernel, every verdict equal to native `pairing_check_eq`;
     `verify_signature_share_pairs` on 64 shares (13 forged) the same;
     device ms per batch by events around the batch replayed as a CUDA graph
     (its verdicts held against the eager batch's) beside B3's share of it
     and the bound
     (ops/pairing_torch.bound), each circuit's time and plain time; shares/s
     wall on the card against the native per-share loop (32 checks), in
     turns, the hash cache cleared before each; host ms in hash_to_g2,
     normalize_batch and the word conversion; the card's busy share.
 28. the process tier on the card: config 5's era switch (16 nodes) on
     `GpuEngine` with the DKG plane forced, uninterrupted, and again
     snapshotted with `checkpoint.save_sim` at the first epoch boundary
     after the vote where the era-switch DKG is live with parts or acks
     pending, the DKG caches cleared (as in a fresh process), loaded with
     `load_sim` and run to the same epoch: every node's batches, eras, key
     sets, validators, counts and faults byte-identical; the snapshot's
     classes name no module of the JAX package and no torch class but
     `torch.device`; counters set to 0 just before the resumed leg and read
     just after: B2 launched, no other kernel, the two legs' B2 entries
     those of the uninterrupted run; the snapshot's bytes, save and load ms.
     Then config 1 (as phase 26, on `GpuEngine` with the DKG plane forced)
     with `checkpoint_every=1` and a flight recorder on each node, stopped
     after 2 batches: each store's newest generation equals the node's state
     at stop; every node restored from it with `from_checkpoint` (epochs
     aligned to the newest) and restarted, counters set to 0 just before:
     2 agreed, decrypted batches on every node at epochs >= the newest,
     every card verdict and r_i * pk_i equal to the host's replay, B2's
     launches equal to the verify batches plus the DKG plane's, no other
     kernel; every node's final flight dump loads with reason "stop";
     checkpoints persisted and the wall from the restart to the first batch.
 29. the adversarial plane on the card: config 11 (bench.py:985-1068,
     `attack_spec(4, seed=23)`: qhb, encryption and share checks, seed 23,
     a warm epoch and 3 timed) attacked and its honest twin, each on
     `GpuEngine` and the host engine: honest batches, counts, faults,
     injections and byz_* counters byte-identical across the engines,
     `verify_scenario` held, attacked/honest epochs/s >= 0.5 on each
     engine, 0 kernel launches (the reference broadcast makes no device
     call); the same attacked leg with the low-comm broadcast, counters set
     to 0 just before: B1's launches equal to those the sketch calls imply
     (the equivocator's forged codings included), no other kernel, every
     call shape exact, byte-identical across the engines; a 16-node
     attacked low-comm leg (f = 5, 2 epochs) on `GpuEngine`: agreement, the
     contract, B1's launches against the sketch calls; the 4-node dhb era
     switch voting out an equivocating, keygen-corrupting, replay-flooding
     node (seed 9) with the DKG plane forced, against the host engine:
     batches, eras and faults equal, B2's launches by entry equal to the
     DKG plane's MSMs, folds and channel keys; config 12 (bench.py:1071-
     1117), the chaos cluster on `GpuEngine` with the DKG plane forced (4
     nodes, f = 1, full crypto, signed frames, the default wire spec, a
     crash and a restart from a stale checkpoint, traced, 6 epochs under
     fault): liveness, agreement, byte-identical recovery and the wire
     contract (checked inside net/chaos.chaos_cluster), every card verdict
     and r_i * pk_i equal to the host's replay, B2's launches equal to the
     verify batches plus the DKG plane's; the commit gap, the catch-up,
     epochs/s and the timeline fields; the phase's seconds.
 30. the process tier, part 2, on the card: config 13 (bench.py:1228-1281,
     `net/cluster.run_process_chaos(n=4, epochs=3, fast_crypto=False,
     engine="gpu")`): four `python -m hydrabadger_tpu_torch --engine gpu`
     processes with the DKG plane forced (HYDRABADGER_GPU_DKG=1, inherited),
     node 1 SIGKILLed at +2 s and restarted from its store 3 s later, node 2
     skewed +30 s at rate 1.25: agreement, the process-tier contract, exit 0
     on SIGTERM with a final checkpoint, the killed incarnation's flight dump,
     the catch-up; every node's B2 verify batches and launches > 0 read from
     the children's feeds (the supervisor itself launches nothing), the
     restarted incarnation's too, no B1; then the soak tiers, cut: the era
     tier (16 nodes, 2 removal switches, 3 steady epochs an era, the DKG
     plane forced): census flat, agreement, B2's launches by entry equal to
     the DKG plane's; the low-comm tier (16 nodes x 2 epochs a leg): B1's
     launches equal to those the sketch calls imply, the twin byte-equal,
     occupancy 1.0; the TCP tier (4 nodes, full crypto, 3 epochs): its
     bounds, B2's launches equal to the verify batches plus the DKG plane's;
     the sim tier (4 nodes x 300 epochs, the native ACS core): 0 launches.
 31. the native host cores on the card: config 5 as bench.py runs it
     (bench.py:491-652) at 64 nodes on the native ACS core with the DKG
     plane forced on `GpuEngine`: a bootstrap epoch, a removal vote for the
     last node from every other, epochs until every survivor is in era 1
     (at most 8), 2 steady epochs; agreement, the victim gone from every
     survivor's validator set, the faults by kind; counters set to 0 just
     before and read just after: B2's launches by entry equal to the DKG
     plane's MSMs, folds and channel keys, no other kernel; every MSM sum,
     fold and channel key the card computed replayed on the host's native
     routes; B2's device ms (CUDA events around each launch), the card's
     busy share, the bound, the walls (bootstrap, each era epoch, the
     switch, steady epochs/s, the era commit gap) and the host builds'
     seconds.  Then the same leg at 16 nodes on `GpuEngine` (plane forced)
     and the host engine in turns, byte-identical; then config 2's native
     tier (bench.py:468-488: 16 nodes x 20 epochs) on both engines in turns:
     the same batches, 0 launches, epochs/s and queue peaks.
 32. the generic full-crypto epoch, the WIN_CIRCUIT=0 path and the FFT
     route of RS on the card: (a) `FullCryptoConfig(n_nodes=64,
     instances=64, share_chunks=16)` (bench.py:792) with
     HYDRABADGER_DECRYPT_T=0, and the decrypt engine resumed from its
     start and keys: a warm epoch on each, U_next projectively equal on
     all 4096 lanes, instance 0's 64 ciphertexts through the plain
     versions on the card equal limb for limb; 3 counted epochs (counters
     set to 0 just before, read just after): the check, B2's launches by
     entry equal to `launch_counts` (32 `glv_ladder` x 5888 lanes, 22
     `add`, 3 `mul` an epoch), no other kernel, sampled lanes against the
     host oracle; epochs/s of both engines in turns, each launch shape's
     device ms beside its bound; (b) decrypt_T's HYDRABADGER_WIN_CIRCUIT=0
     path at 64 x 64 from the same start: U_next projectively equal to the
     circuit path's, counted: 0 B3 launches and B2's by entry equal to
     `launch_counts` (1,575: 22 `win6` x 94,208 lanes, 64 `dblk4`, 1,482
     `ladd` (the tables' 74, the combine's 1,408), 2 `dbl`, 4 `mul`, 1
     `add`), B2's `win6` at 94,208 lanes equal to its plain version on GLV
     windows 0 and 1 of the epoch's gathered operands, its epochs/s and
     launch shapes' device ms; (c) `GpuEngine.rs_encode_batch` / `rs_reconstruct_batch` with
     HYDRABADGER_NTT_MIN_SHARDS=64 at config 6's geometry (k = 22, p = 42,
     1024 instances, 12-byte shards): bytes equal to the B1 route and the
     host codec, no B1 launch on the route; config 10's RS sweep (k =
     n - 2f, p = 2f at n in 16..255, L = 1024): the FFT route on the host and
     with its transform on the card equal to the matrix route, each timed;
     ops/afft_torch on the card byte-equal to the numpy twins for m = 1..8,
     its device ms at the route's shapes beside the twin's and the bytes
     bound.
 33. the mesh (parallel/mesh.py) at world size 1 on NCCL, in this process
     (a FileStore rendezvous; the group destroyed in a `finally`): (a)
     `broadcast_round_sharded` at 64 nodes (22, 42) x 256 B: received and
     decoded equal to the plain versions of its encode and decode at the
     round's shapes, decoded equal to the proposals, 2 B1 launches, the
     plain time and the bound; (b) `instances_sharded_encode` at config 3's
     geometry (1024 x (22, 42) x 256 B): equal to the plain encode, 1 B1
     launch, the plain time and the bound; (c)
     `full_crypto_epoch_node_sharded` at 64 nodes: the verdict, B2's
     launches by entry equal to `build_full_crypto_epoch(1, 64, 21, 1)`'s
     `launch_counts`, U_next equal limb for limb to the unsharded generic
     epoch's and to phase 32a's instance 0 through the plain versions; (d)
     `full_crypto_epoch_sharded` at 64 nodes x 8 instances: the verdict,
     B2's and B3's launches equal to the decrypt engine's `launch_counts`,
     U_next equal to an unsharded `FullCryptoTensorSim`'s, sampled lanes
     held against the host oracle;
     (e) `pairing_checks_sharded` at config 7's 1024 checks (256 if the
     host takes 10 s or more to build the inputs): the verdict, B3's
     launches by circuit equal to `pairing_torch.schedule`; (f) the fast-path
     TensorSim at config 6's geometry instance-sharded, phase 4's epochs,
     totality reduced over the mesh, the final state equal to phase 4's
     unsharded run; (g) `make_mesh(n_devices=2)` on one card raises.  Every
     leg counted with the counters set to 0 just before and read just
     after, no other kernel; its wall ms, and the collectives' device ms by
     CUDA events (all_to_all_single and all_gather at the round's 1 MiB,
     all_reduce of the verdict's 4 B).

The line before the last is one JSON object {"kernels": [...]} (B3's
entry carries `pairing` and `mesh`, B2's `resume`, `tcp_restart`,
`attack_era_switch`, `chaos_cluster`, `process_cluster`, `soak_era`,
`soak_tcp`, `config5_64node`, `generic_epoch`, `win_circuit0_epoch` and
`mesh`, B1's `attack`, `soak_rbc`, `rs_fft_route` and `mesh`); the last is {"ok": true,
"device": {...}}.
Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from hydrabadger_tpu_torch.experiments._common import timed_ms, wall_ms  # noqa: E402
from hydrabadger_tpu_torch.ops import roofline  # noqa: E402

N_NODES, INSTANCES, SHARD_LEN, EPOCHS = 64, 1024, 12, 50
# rs64-batch64k: one network, 65,536 txns of 250 B an epoch, so 11,637-byte
# shards (odd: B1's row path)
BATCH64K_SHARD_LEN, BATCH64K_EPOCHS = 11_637, 20
FC_NODES, FC_INSTANCES, FC_EPOCHS = 64, 64, 3
COIN_NODES, COIN_INSTANCES, COIN_ROUNDS = 64, 64, 3
DEC_NODES, DEC_ROUNDS = 64, 3
RAGGED = 1013  # a lane count that is no multiple of a block
SIM_NODES, SIM_EPOCHS = 16, 3  # config 2 (bench.py:468-488), 3 epochs
FC_SIM_NODES, FC_SIM_EPOCHS = 4, 2  # the full crypto tier (pure-Python BLS on the host)
SKETCH_K, SKETCH_COLS = (1, 5, 6, 97, 257, 300), (1, 4, 9, 13, 16, 64)
# config 5's Python-core leg (bench.py:539-541): the DHB era switch
DKG_NODES, DKG_SEED, DKG_TXNS = 16, 7, 4
# config 5 at bench.py's 64 nodes on the native ACS core (bench.py:491-652,
# run at 64 nodes): 4096 // 64 two-byte txns a node, seed 0, at most 8 era
# epochs, 2 steady epochs; and config 2's native tier (bench.py:468-488)
C5_NODES, C5_SEED, C5_TXNS, C5_ERA_EPOCHS, C5_STEADY = 64, 0, 4096 // 64, 8, 2
C2_NODES, C2_EPOCHS = 16, 20
# config 7 (bench.py:705-760, run at 1024): verified decryption shares
PAIR_BATCH, PAIR_FORGED, PAIR_SIG = 1024, 8, 64
# config 11 (bench.py:985-1068): the attacked sim, 4 nodes x (1 warm + 3
# timed epochs, cut: PERF.md section 4) and 16 nodes x 2 epochs; the
# attacked era switch's seed
ATTACK_NODES, ATTACK_SEED, ATTACK_EPOCHS = 4, 23, 3
ATTACK16_NODES, ATTACK16_EPOCHS = 16, 2
ERA_ATTACK_SEED = 9
# config 12 (bench.py:1071-1117): the chaos cluster, epochs under fault
CHAOS_EPOCHS, CHAOS_DEADLINE_S = 6, 400.0
# config 13 (bench.py:1228-1281): the process cluster, epochs under fault
PROC_EPOCHS, PROC_DEADLINE_S, PROC_BASE_PORT = 3, 300.0, 15800
# the soak tiers on the card, cut (PERF.md section 4)
SOAK_ERA_NODES, SOAK_ERAS, SOAK_ERA_STEADY = 16, 2, 3
SOAK_RBC_NODES, SOAK_RBC_EPOCHS = 16, 2
SOAK_TCP_EPOCHS, SOAK_TCP_PORT = 3, 15820
SOAK_SIM_NODES, SOAK_SIM_EPOCHS = 4, 300
# phase 32: config 8's generic epoch as bench.py calls it (bench.py:792,
# share_chunks=16), a warm epoch and 3 timed; the RS FFT route at config 6's
# geometry and config 10's RS sweep (bench.py:843, L = 1024)
GEN_CHUNKS, GEN_EPOCHS = 16, 3
RS_K, RS_P, RS_BATCH, RS_SWEEP_N, RS_SWEEP_L = 22, 42, 1024, (16, 32, 64, 128, 192, 255), 1024
# phase 33: the mesh at world size 1 on NCCL: the round at 64 nodes (22, 42)
# x 256 B, config 3's encode (bench.py:826: 1024 instances), the full-crypto
# epochs at 64 nodes (x 8 instances: tests/test_mesh.py:97), config 7's
# 1024 pairing checks
MESH_K, MESH_P, MESH_L, MESH_INSTANCES = 22, 42, 256, 1024
MESH_FC_NODES, MESH_FC_INSTANCES, MESH_PAIRS = 64, 8, 1024


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def ptxas_report(output: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) for each
    kernel in nvcc's -Xptxas -v output; a kernel template shows as its name
    and its integer arguments."""
    rows, entry, spill = [], "?", (0, 0)
    for line in output.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            for i in range(len(entry)):  # <length><name>I<args>E
                n = re.match(r"(\d{1,3})[A-Za-z_]", entry[i:])
                if not n:
                    continue
                start = i + len(n.group(1))
                end = start + int(n.group(1))
                args = re.match(r"I((?:L[ib]\d+E)+)E", entry[end:])
                if args:
                    vals = ", ".join(re.findall(r"L[ib](\d+)E", args.group(1)))
                    entry = f"{entry[start:end]}<{vals}>"
                    break
        elif "bytes spill stores" in line:
            spill = tuple(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif re.search(r"Used \d+ registers", line):
            rows.append((entry, int(re.search(r"Used (\d+) registers", line).group(1)), *spill))
    return rows


def sass_mma_counts(kernels) -> dict:
    """Kernel B1's matrix instructions in its built library, by SASS opcode
    (cuobjdump beside nvcc): IMMA (mma.sync), IGMMA / HGMMA (wgmma)."""
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(kernels.library_path("gf256_matmul"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts: dict = {}
    for op in re.findall(r"\b((?:IMMA|IGMMA|HGMMA)\.\S+)", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


def ladder_scalars(m: int, seed: int) -> list[int]:
    """m scalars below r from a seed, with 0 at lanes 0 and m // 2, 1 at
    lane 1 and r - 1 at lane 2."""
    from hydrabadger_tpu_torch.crypto.bls12_381 import R

    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(m)]
    for i, k in ((0, 0), (m // 2, 0), (1, 1), (2, R - 1)):
        if i < m:
            ks[i] = k
    return ks


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def launch_ms(fn, reps: int = 10, batches: int = 3) -> float:
    """Device ms per call of fn by CUDA events: a spin kernel keeps the card
    busy while the host queues `reps` calls between two events, so the
    calls run back to back and no host gap is timed; median of `batches`."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of spinning ahead of the queue
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return float(np.median(per))


def full_crypto(dev: torch.device, tag: str) -> list[dict]:
    """Phases 6-10: kernels B2 and B3 and the threshold-decrypt main path.
    Returns the two kernels' entries of the `kernels` line."""
    from hydrabadger_tpu_torch.ops import bls_g2_torch, bls_torch, circuit_torch
    from hydrabadger_tpu_torch.ops import decrypt_torch as dt, fq_torch as fq, gf256_torch, limbs
    from hydrabadger_tpu_torch.ops.fp12_circuit import CircuitBuilder
    from hydrabadger_tpu_torch.ops.circuit_torch import CircuitExec
    from hydrabadger_tpu_torch.sim import tensor as ts

    # -- 6. set-up ---------------------------------------------------------
    cfg = ts.FullCryptoConfig(n_nodes=FC_NODES, instances=FC_INSTANCES)
    t0 = time.perf_counter()
    sim = ts.FullCryptoTensorSim(cfg, device="cuda")
    n = cfg.instances * cfg.n_nodes
    q = cfg.threshold + 1
    S = q + 1
    print(f"full-crypto set-up: {n} ciphertexts (key set + {n} host G1 multiplies) "
          f"{time.perf_counter() - t0:.2f} s; t = {cfg.threshold}, q = {q}")
    u0_host = sim.state()  # JAX layout, for the plain run's copy of the start
    worst = {"fq_point": 0, "circuit": 0}

    def hold(kernel, label, got_fn, want_fn):
        got = got_fn()
        torch.cuda.synchronize()
        want = want_fn()
        err = max_abs_err(got, want)
        worst[kernel] = max(worst[kernel], err)
        check(torch.equal(got, want), f"{kernel} != plain at {label} (max err {err})")
        print(f"kernel == plain, exact: {kernel} {label}")

    # -- 7. B2 against its plain version -----------------------------------
    a = sim._U.clone()
    b = fq.jac_double_plain(a).roll(1, -1).contiguous()
    c = a.roll(7, -1).contiguous()
    inf = fq.jac_infinity(1, dev)[:, :, 0]
    b[:, :, 0] = a[:, :, 0]  # P + P
    b[:, :, 1] = inf  # P + infinity
    b[:, :, 3] = a[:, :, 3]
    b[1, :, 3:4] = fq.fq_sub(torch.zeros_like(a[1, :, 3:4]), a[1, :, 3:4])  # P + (-P)
    a_inf = a.clone()
    a_inf[:, :, 2] = inf  # infinity + Q
    for m in (n, 1013):
        x, y, z, xi = (t[..., :m].contiguous() for t in (a, b, c, a_inf))
        hold("fq_point", f"mul [12, {m}]", lambda: fq.fq_mul(x[0], y[1]),
             lambda: fq.fq_mul_plain(x[0], y[1]))
        hold("fq_point", f"dbl [3, 12, {m}]", lambda: fq.jac_double(x),
             lambda: fq.jac_double_plain(x))
        hold("fq_point", f"add [3, 12, {m}] (inf, P+P, P-P lanes)", lambda: fq.jac_add(xi, y),
             lambda: fq.jac_add_plain(xi, y))
        hold("fq_point", f"ladd [3, 12, {m}]", lambda: fq.jac_add_ladder(xi, y),
             lambda: fq.jac_add_ladder_plain(xi, y))
        hold("fq_point", f"dblk4 [3, 12, {m}]", lambda: fq.jac_double_k(x, 4),
             lambda: fq.jac_double_k_plain(x, 4))
        hold("fq_point", f"win6 [3, 12, {m}]", lambda: fq.window_step(x, y, z, 6),
             lambda: fq.window_step_plain(x, y, z, 6))
    wide_a, wide_b = a.repeat(1, 1, q), b.repeat(1, 1, q)
    hold("fq_point", f"dbl [3, 12, {q * n}]", lambda: fq.jac_double(wide_a),
         lambda: fq.jac_double_plain(wide_a))
    hold("fq_point", f"ladd [3, 12, {q * n}]", lambda: fq.jac_add_ladder(wide_a, wide_b),
         lambda: fq.jac_add_ladder_plain(wide_a, wide_b))
    tx = a[0].repeat(1, 64)
    beta = torch.as_tensor(limbs.BETA_MONT, device=dev)[:, None]  # one element, every lane
    hold("fq_point", f"mul [12, {64 * n}] by one constant element (beta)",
         lambda: fq.fq_mul(tx, beta), lambda: fq.fq_mul_plain(tx, beta))
    hold("fq_point", f"mul [12, 1013] by one constant element (beta)",
         lambda: fq.fq_mul(tx[:, :1013], beta), lambda: fq.fq_mul_plain(tx[:, :1013], beta))
    # the decrypt round's ladders: the share ladder at 4096 lanes, the
    # combine's at 1408 (22 x 64), and a ragged 1013, scalar-0 lanes included
    for m, entries in ((n, ("glv_ladder",)), (q * FC_NODES, ("windowed_ladder",)),
                       (RAGGED, ("glv_ladder", "windowed_ladder"))):
        ks = ladder_scalars(m, m)
        x = a[..., :m].contiguous()
        digits = {"glv_ladder": bls_torch.glv_windows(ks),
                  "windowed_ladder": bls_g2_torch.scalars_to_windows(ks)}
        for entry in entries:
            d = torch.from_numpy(digits[entry]).to(dev)
            fn, plain_fn = fq.ENTRIES[entry]
            hold("fq_point", f"{entry} [3, 12, {m}] (scalar-0, 1, r-1 lanes)",
                 lambda: fn(x, d), lambda: plain_fn(x, d))

    # -- 8. B3 against its plain version -----------------------------------
    P = limbs.P
    circuits = [dt._dblk_add_circuit(6), dt._add_circuit(), dt._dblk_add_circuit(4)]
    for circ in circuits:
        sp = circ.slots
        print(f"B3 program {circ.name}: {circ.n_products} products in layers "
              f"{circ.circ.n_lanes}, {sp.warps} warps x 32 lanes per block, {sp.n_slots} "
              f"slots ({sp.n_slots_chain} in a chain), "
              f"{circ.smem} B shared")
    for lanes in (S * n, n, RAGGED):
        k = -(-lanes // n)
        xin = torch.cat([a.repeat(1, 1, k), b.repeat(1, 1, k)])[..., :lanes].contiguous()
        for circ in circuits:
            hold("circuit", f"{circ.name} [6, 12, {lanes}] ({circ.n_products} products)",
                 lambda: circ(xin), lambda: circ.plain(xin))
    # every input element at p - 1, p - 2, 0 or 1 in a third of the lanes:
    # each mix at the top of its range
    edge = torch.from_numpy(limbs.ints_to_limbs_batch([P - 1, P - 2, 0, 1]).T.copy()).to(dev)
    xe = torch.cat([a, b]).clone()
    lane3 = torch.arange((n + 2) // 3, device=dev)
    pick = (lane3[None] + torch.arange(6, device=dev)[:, None]).remainder(4)
    xe[:, :, ::3] = edge[:, pick].transpose(0, 1)  # [6, 12, lanes / 3]
    for circ in circuits:
        hold("circuit", f"{circ.name} [6, 12, {n}], a third of the lanes at p-1, p-2, 0, 1",
             lambda: circ(xe), lambda: circ.plain(xe))
    # the Straus chain at the main path's shape, over a table of distinct
    # points per quorum member
    chain = sim.epoch.straus
    tabs = dt._build_table(torch.cat([b.roll(i, -1) for i in range(q)], -1), 1 << dt.W2,
                           dt._Ops(True)).reshape(3, limbs.N_LIMBS, (1 << dt.W2) * q, n)
    acc0 = fq.jac_infinity(n, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain_plain = chain.plain(acc0, tabs)
    torch.cuda.synchronize()
    chain_plain_ms = (time.perf_counter() - t0) * 1e3
    hold("circuit", f"straus chain [3, 12, {n}] ({len(chain.steps)} steps, "
         f"{chain.products} products per lane, plain loop {chain_plain_ms:.0f} ms)",
         lambda: chain(acc0, tabs), lambda: chain_plain)
    looped = acc0
    for c, entry, take in chain.steps:
        sel = tabs[:, :, entry]
        looped = sel if c is None else chain.circuits[c](torch.cat([looped, sel]))[3 * take : 3 * take + 3]
    check(torch.equal(chain(acc0, tabs), looped), "straus chain != its loop of circuit launches")
    print(f"straus chain == its loop of {sum(c is not None for c, _, _ in chain.steps)} "
          f"single-circuit launches, byte for byte")
    # tests/test_circuit_T.py's crafted signed-carry vector in lane 0
    kp = [(4 * P >> (12 * i)) & 4095 for i in range(35)]
    tt = [0] * 32
    tt[2], tt[3], tt[4], tt[5] = -4096 - kp[2], -kp[3], -kp[4], -kp[5]
    x0 = [(3 - (-v) % 3) % 3 for v in tt]
    x1 = [(x0[j] - tt[j]) // 3 for j in range(32)]
    v0 = sum(d << (12 * i) for i, d in enumerate(x0))
    v1 = sum(d << (12 * i) for i, d in enumerate(x1))
    cb = CircuitBuilder(2)
    i0, i1 = cb.input(0), cb.input(1)
    mix = CircuitExec(cb.compile([i0 - i1 - i1 - i1]), "signed_mix")
    xm = torch.stack([a[0], b[1]])
    xm[:, :, 0] = torch.from_numpy(limbs.ints_to_limbs_batch([v0, v1])).to(dev)
    hold("circuit", f"signed mix [1, -3] [2, 12, {n}]", lambda: mix(xm), lambda: mix.plain(xm))
    got0 = limbs.limbs_to_ints_batch(mix(xm)[0, :, :1].T.cpu().numpy())[0]
    check(got0 == (v0 - 3 * v1) % P, "signed-mix vector != (v0 - 3 v1) mod p")
    print("signed-mix regression vector == (v0 - 3 v1) mod p")

    # -- 9. the main path --------------------------------------------------
    t0 = time.perf_counter()
    check(sim.run(1), "full-crypto warm-up epoch: the check failed")
    print(f"warm-up epoch {time.perf_counter() - t0:.3f} s")
    plain = ts.FullCryptoTensorSim.from_jax(u0_host, sim._sks, sim._master, sim._quorum,
                                            device="cuda", use_kernel=False)
    t0 = time.perf_counter()
    check(plain.run(1), "plain epoch: the check failed")
    plain_epoch_s = time.perf_counter() - t0
    check(torch.equal(sim._U, plain._U), "state after one epoch != the plain versions' epoch")
    print(f"state after one epoch at {FC_NODES} x {FC_INSTANCES} == the same epoch through "
          f"the plain versions on the card ({plain_epoch_s:.2f} s)")
    del plain

    want = sim.epoch.launch_counts()
    torch.cuda.synchronize()
    fq.launches, circuit_torch.launches, gf256_torch.launches = 0, 0, 0
    fq.launches_by_kind.clear()
    circuit_torch.launches_by_circuit.clear()
    t0 = time.perf_counter()
    ok = sim.run(FC_EPOCHS)  # one host sync, at the end
    main_s = time.perf_counter() - t0
    counts = {"fq_point": fq.launches, "circuit": circuit_torch.launches,
              "gf256_matmul": gf256_torch.launches}
    by_entry = {"fq_point": dict(fq.launches_by_kind),
                "circuit": dict(circuit_torch.launches_by_circuit)}
    check(ok, "full-crypto main path: the check failed")
    for kernel in ("fq_point", "circuit"):
        expect = {k: v * FC_EPOCHS for k, v in want[kernel].items()}
        check(by_entry[kernel] == expect,
              f"{kernel} launches {by_entry[kernel]}, the digits imply {expect}")
        check(counts[kernel] > 0, f"main path made no {kernel} launch")
    print(f"main path: {FC_EPOCHS} epochs ok, launches {counts}, by entry {by_entry} "
          f"(== {FC_EPOCHS} x the digits' {want})")
    lanes_checked = [0, n // 2 - 1, n - 1]
    check(sim.oracle_check(lanes_checked), "sampled lanes != the host oracle")
    print(f"last epoch's lanes {lanes_checked} == U + sum lam_i (U sk_i) (host oracle)")

    # -- 10. timings -------------------------------------------------------
    eps = [FC_EPOCHS / main_s]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(sim.run(FC_EPOCHS), "timed run: the check failed")
        eps.append(FC_EPOCHS / (time.perf_counter() - t0))
    print(f"epochs/s at {FC_NODES} nodes x {FC_INSTANCES} instances: "
          f"{[round(e, 3) for e in eps]} {tag}")

    by_name = {circ.name: circ for circ in circuits}
    rows = []
    warps = {**{c.name: c.slots.warps for c in circuits}, chain.name: chain.warps}
    for r in sim.epoch.launch_shapes():
        k = r.lanes // n
        if r.kernel == "fq_point":
            fn, plain_fn = fq.ENTRIES[r.name]
            if r.name == "mul":
                x = a[0].repeat(1, k)
                other = {"a*b": b[1].repeat(1, k), "a*a": x, "a*const": beta}[r.form]
                ins = (x, other)
            else:
                ins = (a.repeat(1, 1, k),) + ((b.repeat(1, 1, k),) if r.name in ("add", "ladd") else ())
            prods = fq.products(r.name)
            ms = launch_ms(lambda: fn(*ins))
            p_ms = wall_ms(lambda: plain_fn(*ins))
        elif r.name == chain.name:
            prods = r.products
            ms = launch_ms(lambda: chain(acc0, tabs))
            p_ms = chain_plain_ms  # one call (phase 8): the loop of 747 plain circuits
        else:
            circ = by_name[r.name]
            xin = torch.cat([a.repeat(1, 1, k), b.repeat(1, 1, k)])
            prods = r.products
            ms = launch_ms(lambda: circ(xin))
            p_ms = wall_ms(lambda: circ.plain(xin))
        ops_ms, bytes_ms = roofline.product_ms(prods * r.lanes, r.elements * r.lanes)
        rows.append({"kernel": r.kernel, "entry": r.name, "form": r.form, "lanes": r.lanes,
                     "per_epoch": r.count, "products_per_lane": prods,
                     "elements_per_lane": r.elements, "ms": ms, "plain_ms": p_ms,
                     "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
        if r.kernel == "circuit":
            rows[-1]["warps"] = warps[r.name]
        print(f"{r.kernel} {r.name}{' ' + r.form if r.form else ''} x {r.lanes} lanes "
              f"({r.count}/epoch, {prods} products per lane): kernel {ms:.4f} ms, plain "
              f"{p_ms:.2f} ms, bound "
              f"{max(ops_ms, bytes_ms):.5f} ms (int8 ops {ops_ms:.5f}, bytes {bytes_ms:.5f}), "
              f"{ms / max(ops_ms, bytes_ms):.0f}x {tag}")
    epoch_ms = 1e3 / float(np.median(eps))
    per = {}
    for kernel in ("fq_point", "circuit"):
        mine = [r for r in rows if r["kernel"] == kernel]
        per[kernel] = {key: sum(r[key] * r["per_epoch"] for r in mine)
                       for key in ("ms", "plain_ms", "bound_ms")}
        # the side that sets the larger part of the summed per-launch bounds
        by_ops = sum(r["bound_ms"] * r["per_epoch"] for r in mine if r["bound_by"] == "operations")
        per[kernel]["bound_by"] = "operations" if 2 * by_ops >= per[kernel]["bound_ms"] else "bytes"
    kern_ms = per["fq_point"]["ms"] + per["circuit"]["ms"]
    bound_total = per["fq_point"]["bound_ms"] + per["circuit"]["bound_ms"]
    print(f"config-8 epoch {epoch_ms:.3f} ms: B2 {per['fq_point']['ms']:.3f} ms + B3 "
          f"{per['circuit']['ms']:.3f} ms of kernel time ({100 * kern_ms / epoch_ms:.1f}%); "
          f"bound {bound_total:.4f} ms (B2 {per['fq_point']['bound_ms']:.4f}, "
          f"{per['fq_point']['bound_by']}; B3 {per['circuit']['bound_ms']:.4f}, "
          f"{per['circuit']['bound_by']}) {tag}")
    print(json.dumps({"full_crypto_shapes": rows, "epochs_per_s": eps,
                      "plain_epoch_s": plain_epoch_s}))

    entries = []
    for kernel, src, replaces in (
        ("fq_point", "fq_point.cu", "hydrabadger_tpu/ops/fq_T.py:506"),
        ("circuit", "circuit.cu", "hydrabadger_tpu/ops/circuit_T.py:336"),
    ):
        p = per[kernel]
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"hydrabadger_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": counts[kernel],
            "max_abs_err": worst[kernel],
            "per": f"one config-8 epoch ({FC_NODES} x {FC_INSTANCES}): every launch shape "
                   f"times its launches per epoch",
            "ms": p["ms"],
            "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"],
            "library_ms": None,
        })
    return entries


def coin_plane(dev: torch.device, tag: str) -> dict:
    """Phases 11-13: kernel B4 and the common-coin main path.  Returns the
    kernel's entry of the `kernels` line."""
    from hydrabadger_tpu_torch.crypto.engine import quorum_prep
    from hydrabadger_tpu_torch.ops import bls_g2_torch as g2, circuit_torch, fq_torch
    from hydrabadger_tpu_torch.ops.bls_torch import launch_counts
    from hydrabadger_tpu_torch.ops import fq2_torch as f2, gf256_torch, limbs
    from hydrabadger_tpu_torch.sim import coin

    cfg = coin.CoinConfig(n_nodes=COIN_NODES, instances=COIN_INSTANCES)
    n_shares, q = cfg.n_nodes * cfg.instances, cfg.threshold + 1
    lanes = q * cfg.instances  # the combine's ladder
    tree, s_ = [], q  # lanes of each level of the combine's pairwise tree
    while s_ > 1:
        tree.append((s_ // 2) * cfg.instances)
        s_ = (s_ + 1) // 2
    t0 = time.perf_counter()
    cr = coin.CoinRound(cfg, device=dev, seed=0)
    print(f"coin set-up: key set (t = {cfg.threshold}), {q} host G1 multiplies, "
          f"{cfg.instances} host hashes onto G2: {time.perf_counter() - t0:.2f} s")
    hashed = [cr.engine.hash_to_g2(doc) for doc in cr.docs]

    # -- 11. B4 against its plain version ---------------------------------
    worst = 0

    def hold(label, got_fn, want_fn):
        nonlocal worst
        got = got_fn()
        torch.cuda.synchronize()
        want = want_fn()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"fq2_point != plain at {label} (max err {err})")
        print(f"kernel == plain, exact: fq2_point {label}")

    rng = np.random.default_rng(11)
    base = torch.from_numpy(limbs.g2_points_to_limbs(hashed)).to(dev)
    multiples = f2.g2_table_plain(base)[1:]  # [15, 3, 2, 12, 64]: 960 distinct points
    pool = multiples.permute(1, 2, 3, 0, 4).reshape(3, 2, limbs.N_LIMBS, -1)
    inf = f2.g2_infinity(1, dev)[..., 0]
    for m in (n_shares, RAGGED):
        a = pool[..., rng.integers(0, pool.shape[-1], m)].contiguous()
        b = f2.g2_double_plain(a).roll(1, -1).contiguous()
        a[..., 0] = inf  # infinity + Q
        b[..., 1] = inf  # P + infinity
        b[..., 2] = a[..., 2]  # P + P
        b[..., 3] = f2.g2_neg(a[..., 3:4])[..., 0]  # P + (-P)
        a[..., 4] = inf
        b[..., 4] = inf  # infinity + infinity
        hold(f"add [3, 2, 12, {m}] (inf, P+P, P-P lanes)", lambda: f2.g2_add(a, b),
             lambda: f2.g2_add_plain(a, b))
        hold(f"table [16, 3, 2, 12, {m}] (an inf lane)", lambda: f2.g2_table(a),
             lambda: f2.g2_table_plain(a))
        acc = f2.g2_double_plain(b)
        acc[..., 8] = inf
        a16 = acc
        for _ in range(f2.DOUBLINGS):
            a16 = f2.g2_double_plain(a16)
        tin = a.clone()
        tin[..., 5] = a16[..., 5]  # table[1] == 16 acc: acc == sel after the doublings
        tin[..., 6] = f2.g2_neg(a16[..., 6:7])[..., 0]  # acc == -sel
        table = f2.g2_table_plain(tin)
        digits = torch.from_numpy(rng.integers(1, 16, m).astype(np.int32)).to(dev)
        digits[5], digits[6], digits[7], digits[8] = 1, 1, 0, 0  # digit 0; lane 8 a scalar-0 lane
        hold(f"step [3, 2, 12, {m}] (acc == sel, acc == -sel, digit 0, scalar-0 lanes)",
             lambda: f2.g2_window_step(acc, table, digits),
             lambda: f2.g2_window_step_plain(acc, table, digits))
    a = pool[..., rng.integers(0, pool.shape[-1], lanes)].contiguous()
    table = f2.g2_table_plain(a)
    digits = torch.from_numpy(rng.integers(0, 16, lanes).astype(np.int32)).to(dev)
    hold(f"table [16, 3, 2, 12, {lanes}]", lambda: f2.g2_table(a), lambda: f2.g2_table_plain(a))
    acc = f2.g2_double_plain(a.roll(3, -1))
    hold(f"step [3, 2, 12, {lanes}]", lambda: f2.g2_window_step(acc, table, digits),
         lambda: f2.g2_window_step_plain(acc, table, digits))
    hold(f"add [3, 2, 12, {tree[0]}] (the tree's first level)",
         lambda: f2.g2_add(a[..., :tree[0]], acc[..., :tree[0]]),
         lambda: f2.g2_add_plain(a[..., :tree[0]], acc[..., :tree[0]]))
    # the round's two ladders (4096 and 1408 lanes) and a ragged 1013, with
    # scalar-0, 1 and r-1 lanes; the plain ladders' one host-timed call each
    ladder_plain_ms = {}
    for m in (n_shares, lanes, RAGGED):
        x = pool[..., rng.integers(0, pool.shape[-1], m)].contiguous()
        w = torch.from_numpy(g2.scalars_to_windows(ladder_scalars(m, m))).to(dev)
        got = f2.g2_ladder(x, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = f2.g2_ladder_plain(x, w)
        torch.cuda.synchronize()
        ladder_plain_ms[m] = (time.perf_counter() - t0) * 1e3
        hold(f"ladder [3, 2, 12, {m}] x [64, {m}] digits (scalar-0, 1, r-1 lanes; plain "
             f"{ladder_plain_ms[m]:.0f} ms)", lambda: got, lambda: want)

    # -- 12. the main path -------------------------------------------------
    t0 = time.perf_counter()
    cr.run()
    print(f"warm-up coin round {time.perf_counter() - t0:.3f} s")
    plain = coin.CoinRound(cfg, device=dev, seed=0, use_kernel=False)
    t0 = time.perf_counter()
    plain.run()
    plain_round_s = time.perf_counter() - t0
    check(torch.equal(cr.shares_limbs, plain.shares_limbs),
          "the round's shares != the plain versions' round, limb for limb")
    check(torch.equal(cr.signatures_limbs, plain.signatures_limbs),
          "the round's combined signatures != the plain versions' round, limb for limb")
    check(cr.coins == plain.coins, "coin bits != the plain versions' round")
    print(f"coin round at {cfg.n_nodes} x {cfg.instances}: shares and signatures == the same "
          f"round through the plain versions on the card, limb for limb ({plain_round_s:.2f} s)")
    del plain

    plan = cr.plan()
    want = {part: len(rows) for part, rows in plan.items()}
    want_by_kind = launch_counts(plan["sign"] + plan["combine"])
    torch.cuda.synchronize()
    f2.launches, fq_torch.launches, circuit_torch.launches, gf256_torch.launches = 0, 0, 0, 0
    f2.launches_by_kind.clear()
    t0 = time.perf_counter()
    sigs, coins = cr.run()
    round_s = [time.perf_counter() - t0]
    counted = f2.launches
    by_kind = dict(f2.launches_by_kind)
    others = fq_torch.launches + circuit_torch.launches + gf256_torch.launches
    check(cr.last_launches == want, f"coin round launches {cr.last_launches}, the plan {want}")
    check(by_kind == want_by_kind, f"fq2_point launches by entry {by_kind}, the plan {want_by_kind}")
    check(counted == sum(want.values()) == 2 + len(tree),
          f"fq2_point launches {counted}, the plan {sum(want.values())}")
    check(others == 0, f"the coin round launched {others} kernels of other libraries")
    print(f"main path: one coin round, fq2_point launches {counted} ({cr.last_launches}, "
          f"by entry {by_kind}) == the plan from the digits")
    sample = [0, 1, cfg.n_nodes + 5, n_shares // 2, n_shares - 1]
    t0 = time.perf_counter()
    check(cr.oracle_check(sample), "coin round != the host oracle")
    print(f"shares {sample} == mul_sub(H(doc), sk_i) and all {cfg.instances} signatures == "
          f"master * H(doc) (host oracle, {time.perf_counter() - t0:.2f} s)")
    print(f"coin bits: {''.join('1' if c else '0' for c in coins)}")

    # -- 13. timings -------------------------------------------------------
    for _ in range(COIN_ROUNDS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cr.run()
        round_s.append(time.perf_counter() - t0)
    print(f"coin rounds/s at {cfg.n_nodes} x {cfg.instances} (wall, hashes cached at set-up): "
          f"{[round(1 / s, 3) for s in round_s]} {tag}")
    items = [(sk, doc) for doc in cr.docs for sk in cr._sks]
    jobs = [(cr.pk_set, {i: cr.shares[j * cfg.n_nodes + i] for i in qu})
            for j, qu in enumerate(cr.quorums)]
    sign_wall = wall_ms(lambda: cr.engine.sign_share_batch(items))
    comb_wall = wall_ms(lambda: cr.engine.combine_signature_shares_batch(jobs))
    cols = {doc: k for k, doc in enumerate(cr.docs)}
    sign_pts = base[..., [cols[doc] for _sk, doc in items]].contiguous()
    sign_wins = torch.from_numpy(g2.scalars_to_windows([sk.scalar for sk, _ in items])).to(dev)
    prepared, _ = quorum_prep([(cfg.threshold, shares) for _, shares in jobs])
    comb_pts, comb_wins, _ = g2.weighted_sum_operands([p for p, _ in prepared],
                                                      [lam for _, lam in prepared], dev)
    sign_ms = timed_ms(lambda: g2.g2_scalar_mul_windowed(sign_pts, sign_wins), 5)
    comb_ms = timed_ms(lambda: g2.g2_weighted_sum_windowed(comb_pts, comb_wins, q), 5)
    print(f"sign {n_shares} shares: device {sign_ms:.3f} ms ({n_shares / sign_ms * 1e3:.1f} "
          f"shares/s), wall {sign_wall:.1f} ms ({n_shares / sign_wall * 1e3:.1f} shares/s); "
          f"combine {cfg.instances} x {q}: device {comb_ms:.3f} ms "
          f"({cfg.instances / comb_ms * 1e3:.1f} combines/s), wall {comb_wall:.1f} ms "
          f"({cfg.instances / comb_wall * 1e3:.1f} combines/s) {tag}")

    # per launch at the main path's shapes and operands; the bound counts
    # what this round's digits need (the plan)
    ladder_ops = {n_shares: (sign_pts, sign_wins), lanes: (comb_pts, comb_wins)}
    per_launch = {}
    for r in plan["sign"] + plan["combine"]:
        if (r.entry, r.lanes) in per_launch:
            continue
        if r.entry == "ladder":
            ins = ladder_ops[r.lanes]
            per_launch[r.entry, r.lanes] = (launch_ms(lambda: f2.g2_ladder(*ins), reps=3),
                                            ladder_plain_ms[r.lanes])
        else:
            x = pool[..., rng.integers(0, pool.shape[-1], r.lanes)].contiguous()
            y = f2.g2_double_plain(x.roll(1, -1))
            per_launch[r.entry, r.lanes] = (launch_ms(lambda: f2.g2_add(x, y)),
                                            wall_ms(lambda: f2.g2_add_plain(x, y)))
    rows = {}
    for r in plan["sign"] + plan["combine"]:
        ops_ms, bytes_ms = r.bound()
        row = rows.setdefault((r.entry, r.lanes), {
            "entry": r.entry, "lanes": r.lanes, "per_round": 0, "products_needed": 0,
            "elements_per_lane": r.elements, "digit_bytes_per_lane": r.digit_bytes,
            "ms": per_launch[r.entry, r.lanes][0], "plain_ms": per_launch[r.entry, r.lanes][1],
            "bound_ms": 0.0, "ops_bound_ms": 0.0, "bytes_bound_ms": 0.0})
        row["per_round"] += 1
        row["products_needed"] += r.products
        row["ops_bound_ms"] += ops_ms
        row["bytes_bound_ms"] += bytes_ms
        row["bound_ms"] += max(ops_ms, bytes_ms)
    rows = list(rows.values())
    for r in rows:
        r["bound_by"] = "operations" if r["ops_bound_ms"] >= r["bytes_bound_ms"] else "bytes"
        per_b = r["bound_ms"] / r["per_round"]
        print(f"fq2_point {r['entry']} x {r['lanes']} lanes ({r['per_round']}/round): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound {per_b:.5f} ms per launch "
              f"({r['bound_by']}; {r['products_needed'] / r['per_round'] / r['lanes']:.1f} products "
              f"per lane needed), {r['ms'] / per_b:.0f}x {tag}")
    # the entries kept beside the ladder (no coin-round launch), per launch at
    # the round's lane counts; the bound charges a step's add the general formula
    kept = []
    for entry, m in (("table", n_shares), ("step", n_shares), ("table", lanes), ("step", lanes)):
        x = pool[..., rng.integers(0, pool.shape[-1], m)].contiguous()
        ins = (x,) if entry == "table" else (
            f2.g2_double_plain(x.roll(1, -1)), f2.g2_table_plain(x),
            torch.from_numpy(rng.integers(0, 16, m).astype(np.int32)).to(dev))
        fn, plain_fn = f2.ENTRIES[entry]
        products = (f2.TABLE_PRODUCTS if entry == "table" else
                    f2.DOUBLINGS * f2.DBL_PRODUCTS + f2.GENERAL_ADD_PRODUCTS)
        b_ms = max(roofline.product_ms(products * m, f2.ELEMENTS[entry] * m))
        kept.append({"entry": entry, "lanes": m, "ms": launch_ms(lambda: fn(*ins)),
                     "plain_ms": wall_ms(lambda: plain_fn(*ins)), "bound_ms": b_ms})
        print(f"fq2_point {entry} x {m} lanes (kept beside the ladder; 0/round): kernel "
              f"{kept[-1]['ms']:.4f} ms (PR 3's kernel: table 1.168 / 1.165, step 0.2469 / "
              f"0.2465 ms at 4096 / 1408), plain {kept[-1]['plain_ms']:.2f} ms, bound "
              f"{b_ms:.5f} ms {tag}")
    per = {"ms": sum(r["ms"] * r["per_round"] for r in rows),
           "plain_ms": sum(r["plain_ms"] * r["per_round"] for r in rows),
           "bound_ms": sum(r["bound_ms"] for r in rows)}
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    bound_by = "operations" if 2 * by_ops >= per["bound_ms"] else "bytes"
    round_ms = 1e3 * float(np.median(round_s))
    print(f"coin round {round_ms:.2f} ms wall; device {sign_ms + comb_ms:.3f} ms by events "
          f"(PR 3-4's kernel: 34.26-34.46 ms), B4 launches {per['ms']:.3f} ms by shape; bound "
          f"{per['bound_ms']:.4f} ms ({bound_by}) {tag}")
    print(json.dumps({"coin_shapes": rows, "kept_entries": kept, "coin_round_s": round_s,
                      "plain_round_s": plain_round_s,
                      "sign_device_ms": sign_ms, "combine_device_ms": comb_ms,
                      "sign_wall_ms": sign_wall, "combine_wall_ms": comb_wall}))
    return {
        "name": "fq2_point",
        "route": "cuda",
        "source": "hydrabadger_tpu_torch/csrc/fq2_point.cu",
        "replaces": "hydrabadger_tpu/ops/fq2_T.py:245",
        "also_replaces": ["hydrabadger_tpu/ops/fq2_T.py:282"],
        "launches": counted,
        "max_abs_err": worst,
        "per": f"one coin round ({cfg.n_nodes} x {cfg.instances}): every launch shape times "
               f"its launches per round",
        "kept_entries": kept,
        "ms": per["ms"],
        "plain_ms": per["plain_ms"],
        "bound_ms": per["bound_ms"],
        "bound_by": bound_by,
        "library_ms": None,
    }


def fp_probes(dev: torch.device, tag: str) -> dict:
    """Phases 14-15: the fp_probe kernel (E1-E4) against its plain version
    and the probes' timings.  Returns the kernel's entry of the `kernels`
    line."""
    from hydrabadger_tpu_torch.experiments import (cuda_fq, prof_fixed_cost, prof_mix_vs_mul,
                                                   prof_mul_variants)
    from hydrabadger_tpu_torch.experiments._common import fp_operands
    from hydrabadger_tpu_torch.ops import fp_probe_torch as fp

    # -- 14. fp_probe against its plain version ------------------------------
    worst = 0

    def hold(label, got_fn, want_fn):
        nonlocal worst
        got = got_fn()
        torch.cuda.synchronize()
        want = want_fn()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"fp_probe != plain at {label} (max err {err})")
        print(f"kernel == plain, exact: fp_probe {label}")

    for m in (cuda_fq.LANES, RAGGED):
        a, b = fp_operands(m, 11, dev), fp_operands(m, 12, dev)
        for t in cuda_fq.THREADS:
            hold(f"mul [12, {m}] threads {t}", lambda: fp.fp_mul(a, b, t),
                 lambda: fp.fp_mul_plain(a, b))
    for m, iters in [(n, prof_mul_variants.ITERS[0]) for n in prof_mul_variants.LANES] + [
            (RAGGED, prof_mul_variants.ITERS[1])]:
        x, b = fp_operands(m, 13, dev), fp_operands(m, 14, dev)
        for body in fp.BODIES:
            hold(f"chain {body} x {iters} [12, {m}]", lambda: fp.fp_chain(x, b, body, iters),
                 lambda: fp.fp_chain_plain(x, b, body, iters))
    for w in (prof_mix_vs_mul.LANES * prof_mix_vs_mul.BATCH, RAGGED):
        x = fp_operands(2 * w, 15, dev)
        for t in prof_mix_vs_mul.THREADS:
            hold(f"mul_layer [12, 2 x {w}] threads {t}", lambda: fp.fp_mul_layer(x, t),
                 lambda: fp.fp_mul_layer_plain(x))
    rng = np.random.default_rng(16)
    for shape in (prof_fixed_cost.SHAPE, (RAGGED,)):
        x = torch.from_numpy(rng.integers(-2**20, 2**20, shape).astype(np.int32)).to(dev)
        for inner in (1, 100):
            hold(f"noop +{inner} {list(shape)}", lambda: fp.noop(x, inner),
                 lambda: fp.noop_plain(x, inner))

    # -- 15. the probes: their modules' entry points, counted ------------------
    torch.cuda.synchronize()
    fp.launches = 0
    fp.launches_by_entry.clear()
    e1 = cuda_fq.measure(dev)
    e2 = prof_mul_variants.measure(dev)
    e3 = prof_mix_vs_mul.measure(dev)
    e4 = prof_fixed_cost.measure(dev)
    counted, by_entry = fp.launches, dict(fp.launches_by_entry)
    want = {"mul", "mul_layer", "noop"} | {f"chain_{body}" for body in fp.BODIES}
    check(set(by_entry) == want and min(by_entry.values()) > 0,
          f"the probes' fp_probe launches by entry {by_entry}")
    print(f"the probes: fp_probe launches {counted}, by entry {by_entry}")
    for r in e1:
        print(f"E1 mul x {r['lanes']} lanes, {r['threads']} threads: {r['ms']:.5f} ms per launch, "
              f"{r['ns_per_product']:.4f} ns/product; bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"{r['ms'] / r['bound_ms']:.1f}x; plain {r['plain_ms']:.2f} ms {tag}")
    for r in e2:
        print(f"E2 chain {r['body']} x {r['lanes']} lanes: {r['ms'] * 1e3:.3f} us per body, "
              f"{r['ns_per_lane']:.4f} ns/lane; bound {r['bound_ms'] * 1e3:.4f} us "
              f"({r['bound_by']}), {r['ms'] / r['bound_ms']:.1f}x {tag}")
    for r in e3:
        print(f"E3 {r['entry']} ({r['products']} products{', ' + str(r['threads']) + ' threads' if 'threads' in r else ''}): "
              f"{r['ms']:.5f} ms per launch, {r['ns_per_product']:.4f} ns/product; bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}); plain {r['plain_ms']:.2f} ms {tag}")
    for r in e4:
        print(f"E4 {r['entry']} inner {r['inner']}: {r['us_per_launch']:.3f} us per launch over "
              f"{r['launches']}; bound {r['bound_us']:.4f} us ({r['bound_by']}) {tag}")
    print(json.dumps({"fp_probes": e1 + e2 + e3 + e4}))

    best = min(e1, key=lambda r: r["ms"])
    full8k = next(r for r in e2 if r["body"] == "full")  # at E2's own 8192 lanes
    layer = min((r for r in e3 if r["entry"] == "mul_layer"), key=lambda r: r["ms"])
    circ = next(r for r in e3 if r["entry"] != "mul_layer")
    q = {r["entry"]: r for r in e4 if r["inner"] == 1}

    def entry(probe, replaces, r, ms, plain_ms, bound, by, library_ms=None):
        return {"probe": probe, "replaces": replaces, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": library_ms, "shape": r}

    per_probe = [
        entry("E1", "experiments/pallas_fq.py:87", f"mul x {best['lanes']}, {best['threads']} threads",
              best["ms"], best["plain_ms"], best["bound_ms"], best["bound_by"]),
        entry("E2", "experiments/prof_mul_variants.py:44", f"chain full, one body x {full8k['lanes']} lanes",
              full8k["ms"], full8k["plain_ms"], full8k["bound_ms"], full8k["bound_by"]),
        entry("E3", "experiments/prof_mix_vs_mul.py:60",
              f"mul_layer x {layer['products']}, {layer['threads']} threads (B3 add circuit at "
              f"the same products: {circ['ms']:.5f} ms)", layer["ms"], layer["plain_ms"],
              layer["bound_ms"], layer["bound_by"]),
        entry("E4", "experiments/prof_fixed_cost.py:27", "noop [32, 1024] +1, back to back",
              q["back_to_back"]["us_per_launch"] / 1e3, q["back_to_back"]["plain_us"] / 1e3,
              q["back_to_back"]["bound_us"] / 1e3,
              q["back_to_back"]["bound_by"], q["torch x + 1 back_to_back"]["us_per_launch"] / 1e3),
    ]
    return {
        "name": "fp_probe",
        "route": "cuda",
        "source": "hydrabadger_tpu_torch/csrc/fp_probe.cu",
        "replaces": "experiments/pallas_fq.py:87",
        "also_replaces": ["experiments/prof_mul_variants.py:44", "experiments/prof_mix_vs_mul.py:60",
                          "experiments/prof_fixed_cost.py:27"],
        "launches": counted,
        "path": "the probe modules (hydrabadger_tpu_torch/experiments/); no epoch path runs it",
        "max_abs_err": worst,
        "per": f"E1: one mul launch over {best['lanes']} lanes, {best['threads']} threads per block",
        "ms": best["ms"],
        "plain_ms": best["plain_ms"],
        "bound_ms": best["bound_ms"],
        "bound_by": best["bound_by"],
        "library_ms": None,
        "probes": per_probe,
    }


def decrypt_plane(dev: torch.device, tag: str) -> dict:
    """Phase 16: the threshold-decrypt round on kernel B2.  Returns the
    round's numbers for kernel B2's entry of the `kernels` line."""
    from hydrabadger_tpu_torch.ops import bls_torch, circuit_torch, fq_torch
    from hydrabadger_tpu_torch.ops import fp_probe_torch, fq2_torch, gf256_torch
    from hydrabadger_tpu_torch.sim import decrypt

    cfg = decrypt.DecryptConfig(n_nodes=DEC_NODES)
    n_shares, q = cfg.n_nodes * cfg.n_nodes, cfg.threshold + 1
    t0 = time.perf_counter()
    rnd = decrypt.DecryptRound(cfg, device=dev, seed=0)
    print(f"decrypt set-up: key set (t = {cfg.threshold}), {q} host G1 multiplies, "
          f"{cfg.n_nodes} host encryptions: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rnd.run()
    print(f"warm-up decrypt round {time.perf_counter() - t0:.3f} s")
    plain = decrypt.DecryptRound(cfg, device=dev, seed=0, use_kernel=False)
    t0 = time.perf_counter()
    plain.run()
    plain_round_s = time.perf_counter() - t0
    check(torch.equal(rnd.shares_limbs, plain.shares_limbs),
          "the round's decryption shares != the plain versions' round, limb for limb")
    check(torch.equal(rnd.combined_limbs, plain.combined_limbs),
          "the round's combined points != the plain versions' round, limb for limb")
    check(rnd.plaintexts == plain.plaintexts, "plaintexts != the plain versions' round")
    print(f"decrypt round at {cfg.n_nodes} x {cfg.n_nodes}: {n_shares} shares and "
          f"{cfg.n_nodes} combined points == the same round through the plain versions on the "
          f"card, limb for limb ({plain_round_s:.2f} s)")
    del plain

    plan = rnd.plan()
    want = {part: bls_torch.launch_counts(rows) for part, rows in plan.items()}
    want_by_kind = {}
    for counts in want.values():
        for k, v in counts.items():
            want_by_kind[k] = want_by_kind.get(k, 0) + v
    torch.cuda.synchronize()
    fq_torch.launches, fq2_torch.launches, circuit_torch.launches = 0, 0, 0
    gf256_torch.launches, fp_probe_torch.launches = 0, 0
    fq_torch.launches_by_kind.clear()
    t0 = time.perf_counter()
    plaintexts = rnd.run()
    round_s = [time.perf_counter() - t0]
    counted, by_kind = fq_torch.launches, dict(fq_torch.launches_by_kind)
    others = fq2_torch.launches + circuit_torch.launches + gf256_torch.launches + fp_probe_torch.launches
    check(rnd.last_launches == {part: len(rows) for part, rows in plan.items()},
          f"decrypt round launches {rnd.last_launches}, the digits' plan {want}")
    check(by_kind == want_by_kind, f"fq_point launches by entry {by_kind}, the plan {want_by_kind}")
    check(others == 0, f"the decrypt round launched {others} kernels of other libraries")
    print(f"main path: one decrypt round, fq_point launches {counted} ({rnd.last_launches}, "
          f"by entry {by_kind}) == the plan from the digits")
    sample = [0, 1, cfg.n_nodes + 5, n_shares // 2, n_shares - 1]
    t0 = time.perf_counter()
    check(rnd.oracle_check(sample), "decrypt round != the host oracle")
    check(plaintexts == rnd.contributions, "a plaintext != the contribution encrypted")
    print(f"shares {sample} == mul_sub(U, sk_i), all {cfg.n_nodes} combined points == "
          f"U * master (host oracle, {time.perf_counter() - t0:.2f} s); all {cfg.n_nodes} "
          f"plaintexts == the {cfg.contribution_bytes}-byte contributions encrypted")

    for _ in range(DEC_ROUNDS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rnd.run()
        round_s.append(time.perf_counter() - t0)
    items = rnd.items()
    pts, digits = bls_torch.scalar_mul_operands([ct.u for _sk, ct in items],
                                                [sk.scalar for sk, _ct in items], dev)
    lams = rnd.lagrange()
    cpts, cwins, _ = bls_torch.weighted_sum_operands(
        [[rnd.shares[j * cfg.n_nodes + i].point for i in qu] for j, qu in enumerate(rnd.quorums)],
        lams, dev)
    share_ms = timed_ms(lambda: bls_torch.g1_scalar_mul_glv(pts, digits), 5)
    comb_ms = timed_ms(lambda: bls_torch.g1_weighted_sum_windowed(cpts, cwins, q), 5)
    share_plain = wall_ms(lambda: bls_torch.g1_scalar_mul_glv(pts, digits, use_kernel=False))
    comb_plain = wall_ms(lambda: bls_torch.g1_weighted_sum_windowed(cpts, cwins, q, use_kernel=False))
    share_wall = wall_ms(lambda: rnd.engine.decrypt_share_batch(items))
    bound = {}
    for part, rows in plan.items():
        per_launch = [r.bound() for r in rows]
        bound[part] = {"bound_ms": sum(max(b) for b in per_launch),
                       "ops_ms": sum(b[0] for b in per_launch),
                       "bytes_ms": sum(b[1] for b in per_launch),
                       "products": sum(r.products for r in rows)}
    bound_ms = sum(b["bound_ms"] for b in bound.values())
    bound_by = ("operations" if sum(b["ops_ms"] for b in bound.values())
                >= sum(b["bytes_ms"] for b in bound.values()) else "bytes")
    round_ms = 1e3 * float(np.median(round_s))
    dev_ms = share_ms + comb_ms
    print(f"decrypt round {round_ms:.2f} ms wall (median of {len(round_s)}; "
          f"{[round(1 / s, 3) for s in round_s]} rounds/s); shares {share_ms:.3f} ms + combine "
          f"{comb_ms:.3f} ms device by events (PR 4's kernel: 20.72 ms; "
          f"{n_shares / share_ms * 1e3:.1f} shares/s, "
          f"{cfg.n_nodes / comb_ms * 1e3:.1f} combines/s device-only); share batch wall "
          f"{share_wall:.1f} ms; bound {bound_ms:.4f} ms ({bound_by}; shares "
          f"{bound['share']['bound_ms']:.4f}, combine {bound['combine']['bound_ms']:.4f}), "
          f"{dev_ms / bound_ms:.0f}x; plain ladders {share_plain:.1f} + {comb_plain:.1f} ms {tag}")
    print(json.dumps({"decrypt_round_s": round_s, "plain_round_s": plain_round_s,
                      "share_device_ms": share_ms, "combine_device_ms": comb_ms,
                      "share_plain_ms": share_plain, "combine_plain_ms": comb_plain,
                      "share_wall_ms": share_wall, "bound": bound, "launches": rnd.last_launches}))
    return {
        "per": f"one decrypt round ({cfg.n_nodes} x {cfg.n_nodes}): the share ladder and the "
               f"combine, device time by events",
        "launches": counted,
        "ms": dev_ms,
        "plain_ms": share_plain + comb_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def sim_plane(dev: torch.device, tag: str) -> tuple[dict, int]:
    """Phases 17-20: kernel B1 at the low-comm sketch shapes, and the
    QueueingHoneyBadger simulator on the card against the host engine.
    Returns the sim's record for kernel B1's entry of the `kernels` line
    and the worst error of the phase-17 holds."""
    from hydrabadger_tpu_torch.crypto import homhash
    from hydrabadger_tpu_torch.crypto.engine import GpuEngine
    from hydrabadger_tpu_torch.ops import circuit_torch, fp_probe_torch, fq2_torch, fq_torch
    from hydrabadger_tpu_torch.ops import gf256_torch, homhash_torch
    from hydrabadger_tpu_torch.sim import network

    # -- 17. B1 exact at the sketch shapes ---------------------------------
    # m = 8 sketch rows, K = the shard length, 1-64 shard columns: the
    # contiguous [K, B] copy the engine uploads (the word path where
    # B % 4 == 0) and the transposed view of [B, K] shards (the byte path)
    worst = 0
    for k in SKETCH_K:
        mat = homhash.matrix_T(b"smoke-%d" % k, k)
        for cols in SKETCH_COLS:
            rows = np.random.default_rng(k * 131 + cols).integers(0, 256, (cols, k), dtype=np.uint8)
            shards = torch.from_numpy(rows).to(dev)
            for form, data in (("contiguous", shards.T.contiguous()), ("strided", shards.T)):
                got = gf256_torch.gf_matmul(mat, data)
                want = gf256_torch.gf_matmul_bits_plain(mat, data)
                torch.cuda.synchronize()
                worst = max(worst, max_abs_err(got, want))
                check(torch.equal(got, want), f"gf256_matmul != plain at sketch (8,{k}) x {cols} {form}")
                check(np.array_equal(got.cpu().numpy().T, homhash.sketch_batch_np(rows, b"smoke-%d" % k)),
                      f"sketch (8,{k}) x {cols} {form} != crypto/homhash.sketch_batch_np")
    print(f"kernel == plain == sketch_batch_np, exact: m = 8, K in {SKETCH_K} "
          f"({[len(gf256_torch.chunks(8, k)) for k in SKETCH_K]} launches), columns in {SKETCH_COLS}, "
          "contiguous and strided")
    empty = torch.zeros((0, 5), dtype=torch.uint8, device=dev)
    out = torch.full((8, 5), 0xAB, dtype=torch.uint8, device=dev)
    before = gf256_torch.launches
    gf256_torch.gf_matmul(np.zeros((8, 0), np.uint8), empty, out=out)
    torch.cuda.synchronize()
    check(not bool(out.any()) and gf256_torch.launches == before, "k = 0 did not give zeros without a launch")
    print("k = 0: zeros, no launch")

    def run(engine, nodes, epochs, variant, **kw):
        sim = network.SimNetwork(network.SimConfig(
            n_nodes=nodes, protocol="qhb", epochs=epochs, seed=0, rbc_variant=variant,
            engine=engine, native_acs=False, **kw))
        t0 = time.perf_counter()
        m = sim.run()
        return sim, m, time.perf_counter() - t0

    def same(a, am, b, bm, epochs, what):
        check(am.agreement_ok and bm.agreement_ok, f"{what}: agreement failed")
        check(am.epochs_done == bm.epochs_done == epochs,
              f"{what}: epochs_done {am.epochs_done} / {bm.epochs_done}, want {epochs}")
        for nid in a.ids:
            check(a.batch_bytes(nid) == b.batch_bytes(nid), f"{what}: node {nid}'s batches differ")
        check((am.messages_delivered, am.txns_committed, am.faults)
              == (bm.messages_delivered, bm.txns_committed, bm.faults),
              f"{what}: messages / txns / faults {am.messages_delivered, am.txns_committed, am.faults}"
              f" != {bm.messages_delivered, bm.txns_committed, bm.faults}")

    def counts():
        return {"gf256_matmul": gf256_torch.launches, "fq_point": fq_torch.launches,
                "fq2_point": fq2_torch.launches, "circuit": circuit_torch.launches,
                "fp_probe": fp_probe_torch.launches}

    def zero_counts():
        torch.cuda.synchronize()
        gf256_torch.launches = fq_torch.launches = fq2_torch.launches = 0
        circuit_torch.launches = fp_probe_torch.launches = 0

    gpu = GpuEngine(device=dev)
    run(gpu, 4, 1, "lowcomm")  # warm-up: the library's load and first launches

    # -- 18. config 2 on the card: 16 nodes, low-comm broadcast ------------
    # in turns (host, card, card, host) for epochs/s; the first card run is
    # the counted one
    host, host_m, host_s = run("cpu", SIM_NODES, SIM_EPOCHS, "lowcomm")
    homhash_torch.calls.clear()
    gf256_torch.operand_s = 0.0
    zero_counts()
    card, card_m, card_s = run(gpu, SIM_NODES, SIM_EPOCHS, "lowcomm")
    launched = counts()
    operand_ms = 1e3 * gf256_torch.operand_s
    calls = dict(homhash_torch.calls)
    same(card, card_m, host, host_m, SIM_EPOCHS, "lowcomm sim, gpu vs cpu")
    turns = {"gpu": [card_m.epochs_done / card_s], "cpu": [host_m.epochs_done / host_s]}
    for spec in (gpu, "cpu"):
        again, again_m, again_s = run(spec, SIM_NODES, SIM_EPOCHS, "lowcomm")
        same(again, again_m, host, host_m, SIM_EPOCHS, "lowcomm sim, again")
        turns["cpu" if spec == "cpu" else "gpu"].append(again_m.epochs_done / again_s)
    implied = sum(n * len(gf256_torch.chunks(8, L)) for (_b, L), n in calls.items())
    check(launched["gf256_matmul"] > 0, "the lowcomm sim launched kernel B1 no time")
    check(launched["gf256_matmul"] == implied,
          f"B1 launches {launched['gf256_matmul']} != {implied} implied by the sketch calls")
    check(sum(launched.values()) == launched["gf256_matmul"], f"other kernels launched: {launched}")
    n_calls = sum(calls.values())
    # every call shape of the run, replayed: the kernel exact against its
    # plain version from the contiguous [L, B] copy the engine uploads and
    # from the transposed view of [B, L] shards; then the device work, each
    # shape's products back to back (CUDA events behind a spin kernel, so no
    # host gap is timed) times its count -- events around the calls in the
    # run would time the host's enqueue, since the card waits on the host
    dev_ms = plain_ms = ops_ms = bytes_ms = 0.0
    shapes = {}
    for (B, L), n in sorted(calls.items()):
        op = gf256_torch.operand(homhash.matrix_T(b"replay", L), dev)
        rows = torch.randint(0, 256, (B, L), dtype=torch.uint8, device=dev)
        x = rows.T.contiguous()
        y = torch.empty((8, B), dtype=torch.uint8, device=dev)
        for form, data in (("contiguous", x), ("strided", rows.T)):
            gf256_torch.gf_matmul(op, data, out=y)
            want = gf256_torch.gf_matmul_bits_plain(op, data)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_err(y, want))
            check(torch.equal(y, want), f"gf256_matmul != plain at the run's sketch (8,{L}) x {B} {form}")
        k_ms = launch_ms(lambda: gf256_torch.gf_matmul(op, x, out=y), reps=20)
        p_ms = launch_ms(lambda: gf256_torch.gf_matmul_bits_plain(op, x), reps=5)
        o_ms, b_ms = roofline.gf_matmul_ms(8, L, B)
        shapes[f"{B}x{L}"] = {"calls": n, "ms": k_ms, "plain_ms": p_ms}
        dev_ms, plain_ms = dev_ms + n * k_ms, plain_ms + n * p_ms
        ops_ms, bytes_ms = ops_ms + n * o_ms, bytes_ms + n * b_ms
    rows16 = [bytes(range(i, i + 6)) for i in range(16)]  # 16 shards of config 2's 6 bytes
    call_wall = {"gpu 16x6": wall_ms(lambda: gpu.homhash_batch(rows16, b"wall")),
                 "gpu 1x6": wall_ms(lambda: gpu.homhash_batch(rows16[:1], b"wall")),
                 "cpu 16x6": wall_ms(lambda: host.engine.homhash_batch(rows16, b"wall")),
                 "cpu 1x6": wall_ms(lambda: host.engine.homhash_batch(rows16[:1], b"wall"))}
    cols = sorted({B for B, _L in calls})
    lens = sorted({L for _B, L in calls})
    e = SIM_EPOCHS
    epoch_ms = 1e3 * card_s / card_m.epochs_done
    print(f"main path: config 2 ({SIM_NODES} nodes, qhb, lowcomm) x {e} epochs on the card == the host "
          f"engine: every node's batches byte-identical, {card_m.messages_delivered} messages, "
          f"{card_m.txns_committed} txns, {card_m.faults} faults; launches {launched} == "
          f"{implied} implied by {n_calls} sketch calls (columns {cols}, shard lengths {lens})")
    print(f"config 2 lowcomm, epochs/s in turns (cpu, gpu, gpu, cpu): gpu engine "
          f"{[round(v, 3) for v in turns['gpu']]}, cpu engine {[round(v, 3) for v in turns['cpu']]}; B1 {launched['gf256_matmul'] / e:.1f} launches "
          f"and {n_calls / e:.1f} sketch calls per epoch, {dev_ms / e:.4f} device ms per epoch in the "
          f"sketches ({100 * dev_ms / e / epoch_ms:.2f}% of the {epoch_ms:.1f} ms epoch; by shape "
          f"{ {k: round(v['ms'], 5) for k, v in shapes.items()} } ms per launch), "
          f"{operand_ms / e:.3f} host ms per epoch in operand builds; one sketch call's wall "
          f"{ {k: round(v, 4) for k, v in call_wall.items()} } ms; bound {max(ops_ms, bytes_ms) / e:.6f}"
          f" ms per epoch ({'operations' if ops_ms >= bytes_ms else 'bytes'}); plain "
          f"{plain_ms / e:.4f} ms per epoch {tag}")

    # -- 19. config 2 as users run it: the reference broadcast -------------
    bhost, bhost_m, bhost_s = run("cpu", SIM_NODES, SIM_EPOCHS, "bracha")
    zero_counts()
    bcard, bcard_m, bcard_s = run(gpu, SIM_NODES, SIM_EPOCHS, "bracha")
    blaunched = counts()
    same(bcard, bcard_m, bhost, bhost_m, SIM_EPOCHS, "bracha sim, gpu vs cpu")
    check(sum(blaunched.values()) == 0, f"the bracha sim launched kernels: {blaunched}")
    print(f"config 2 bracha: batches byte-identical, 0 kernel launches ({blaunched}), as the JAX "
          f"TpuEngine makes no device call there; gpu engine {bcard_m.epochs_done / bcard_s:.3f} "
          f"epochs/s, cpu engine {bhost_m.epochs_done / bhost_s:.3f} epochs/s {tag}")

    # -- 20. the full crypto tier: 4 nodes, encryption, threshold coin -------
    fc = dict(encrypt=True, coin_mode="threshold", verify_shares=True)
    fhost, fhost_m, fhost_s = run("cpu", FC_SIM_NODES, FC_SIM_EPOCHS, "lowcomm", **fc)
    zero_counts()
    fcard, fcard_m, fcard_s = run(gpu, FC_SIM_NODES, FC_SIM_EPOCHS, "lowcomm", **fc)
    flaunched = counts()
    same(fcard, fcard_m, fhost, fhost_m, FC_SIM_EPOCHS, "full crypto sim, gpu vs cpu")
    check(flaunched["gf256_matmul"] > 0, "the full crypto sim launched kernel B1 no time")
    print(f"full crypto tier ({FC_SIM_NODES} nodes x {FC_SIM_EPOCHS} epochs, encryption, threshold "
          f"coin, shares verified, lowcomm): batches byte-identical; launches {flaunched}; gpu engine "
          f"{fcard_m.epochs_done / fcard_s:.3f} epochs/s, cpu engine "
          f"{fhost_m.epochs_done / fhost_s:.3f} epochs/s {tag}")
    print(json.dumps({"sim": {
        "lowcomm": {"gpu_epochs_per_s": turns["gpu"], "cpu_epochs_per_s": turns["cpu"],
                    "launches": launched,
                    "sketch_calls": n_calls, "shapes": shapes, "call_wall_ms": call_wall,
                    "device_ms": dev_ms, "operand_host_ms": operand_ms,
                    "plain_ms": plain_ms, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
                    "messages": card_m.messages_delivered},
        "bracha": {"gpu_epochs_per_s": bcard_m.epochs_done / bcard_s,
                   "cpu_epochs_per_s": bhost_m.epochs_done / bhost_s, "launches": blaunched},
        "full_crypto": {"gpu_epochs_per_s": fcard_m.epochs_done / fcard_s,
                        "cpu_epochs_per_s": fhost_m.epochs_done / fhost_s, "launches": flaunched},
        "card": tag}}))
    return {
        "per": f"config 2 ({SIM_NODES} nodes, qhb, lowcomm) x {SIM_EPOCHS} epochs: the shard "
               f"sketches, each call shape's launches timed back to back, times its calls",
        "launches": launched["gf256_matmul"],
        "launches_per_epoch": launched["gf256_matmul"] / e,
        "ms": dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "operand_host_ms": operand_ms,
        "gpu_epochs_per_s": turns["gpu"],
        "cpu_epochs_per_s": turns["cpu"],
    }, worst


def voted_sim(engine, nodes: int, native_acs: bool = False, **kw):
    """Config 5's leg at `nodes` up to its vote, on the Python cores (or the
    native ACS core): the process-wide DKG caches cleared (so every run
    derives its folds and keys itself), a bootstrap epoch, then a removal
    vote for the last node from every other.  Returns (sim, the time it
    started)."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.sim import network

    dkg.clear_caches()
    sim = network.SimNetwork(network.SimConfig(
        n_nodes=nodes, protocol="dhb", txns_per_node_per_epoch=DKG_TXNS, txn_bytes=2,
        seed=DKG_SEED, native_acs=native_acs, engine=engine, **kw))
    t0 = time.perf_counter()
    sim.run(1)
    victim = sim.ids[-1]
    for nid in sim.ids[:-1]:
        sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(victim))
    return sim, t0


def era_switch(engine, nodes: int, **kw):
    """Config 5's leg at `nodes` (`voted_sim`), then epochs until every
    survivor is in the new era, then two steady epochs.  Returns (sim,
    metrics, wall s)."""
    sim, t0 = voted_sim(engine, nodes, **kw)
    for _ in range(8):
        sim.run(1)
        if all(sim.nodes[nid].era > 0 for nid in sim.ids[:-1]):
            break
    check(all(sim.nodes[nid].era > 0 for nid in sim.ids), "the era switch did not complete")
    m = sim.run(2)
    return sim, m, time.perf_counter() - t0


def dhb_record(sim, m) -> dict:
    """What two runs must share: every node's batches (epoch, era, change
    report, contributions' bytes, join plan), eras, public key sets,
    validator sets, counts and faults."""
    def batches(nid):
        return [(b.epoch, b.era, b.change, tuple((p, bytes(v)) for p, v in sorted(b.contributions.items())),
                 None if b.join_plan is None else b.join_plan.wire())
                for b in sim.nodes[nid].batches]

    return {"batches": {nid: batches(nid) for nid in sim.ids},
            "eras": {nid: sim.nodes[nid].era for nid in sim.ids},
            "pk_set": {nid: sim.nodes[nid].netinfo.pk_set.to_bytes() for nid in sim.ids},
            "validators": {nid: tuple(sim.nodes[nid].netinfo.node_ids) for nid in sim.ids},
            "counts": (m.epochs_done, m.messages_delivered, m.bytes_committed, m.faults,
                       m.agreement_ok),
            "faults": [(s, f.node_id, f.kind) for s, f in sim.router.faults]}


def g1_pool(n: int, seed: int) -> list:
    """n distinct host G1 points from a seed."""
    from hydrabadger_tpu_torch.crypto import bls12_381 as bls

    rng = np.random.default_rng(seed)
    return [bls.mul_sub(bls.G1, int.from_bytes(rng.bytes(16), "little") | 1) for _ in range(n)]


def fold_plan(J: int, K: int, xs) -> list:
    """The B2 launches of one fold (ops/vandermonde_torch) and the products
    its points need: a doubling after a lane's first set bit, a ladder add
    where a bit is set after it, a general chain add per lane and row."""
    from hydrabadger_tpu_torch.ops import bls_torch
    from hydrabadger_tpu_torch.ops.roofline import Launch

    nbits = max(int(x).bit_length() for x in xs)
    lanes = len(xs) * K
    rows = []
    for _j in range(J - 1):
        for b in range(nbits):
            started = sum(K for x in xs if x >> (nbits - b) > 0)
            setbit = sum(K for x in xs if (x >> (nbits - 1 - b)) & 1 and x >> (nbits - b) > 0)
            rows.append(Launch("dbl", lanes, started * bls_torch.DBL_PRODUCTS, 6, "fold"))
            rows.append(Launch("ladd", lanes, setbit * bls_torch.GENERAL_ADD_PRODUCTS, 9, "fold"))
        rows.append(Launch("add", lanes, lanes * bls_torch.GENERAL_ADD_PRODUCTS, 9, "fold"))
    return rows


def plan_bound(rows) -> tuple[float, float]:
    """(operations ms, bytes ms) summed over a plan's launches."""
    bounds = [r.bound() for r in rows]
    return sum(b[0] for b in bounds), sum(b[1] for b in bounds)


def dkg_plane(dev: torch.device, tag: str, nodes: int = DKG_NODES) -> dict:
    """Phases 21-23: the era switch's B2 work (ops/msm_torch,
    ops/vandermonde_torch, the channel keys on ops/bls_torch) against the
    plain versions, and the DynamicHoneyBadger era switch on the card
    against the host engine.  Returns the switch's record for kernel B2's
    entry of the `kernels` line."""
    from hydrabadger_tpu_torch.crypto import bls12_381 as bls
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto.engine import GpuEngine
    from hydrabadger_tpu_torch.obs import metrics as M
    from hydrabadger_tpu_torch.ops import bls_torch, circuit_torch, fp_probe_torch, fq2_torch
    from hydrabadger_tpu_torch.ops import fq_torch, gf256_torch, limbs, msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt

    worst = 0
    R = bls.R

    def hold(label, got_fn, want_fn):
        """Kernel against plain on the card, exact; returns (got, the plain
        call's host ms)."""
        nonlocal worst
        got = got_fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = want_fn()
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"fq_point != plain at {label} (max err {err})")
        print(f"kernel == plain, exact: {label}")
        return got, p_ms

    def msm_hold(label, jobs, oracle: bool):
        pts, digits, b, s = msm_torch.operands(jobs, dev)
        got, p_ms = hold(f"msm {label}: B = {b}, S = {s}, digits {list(digits.shape)}",
                         lambda: msm_torch.msm(pts, digits, b, s),
                         lambda: msm_torch.msm(pts, digits, b, s, use_kernel=False))
        if oracle:
            host = limbs.limbs_to_points(got.cpu().numpy())
            check(all(bls.eq(h, dkg.g1_msm_or_fallback(p, k)) for h, (p, k) in zip(host, jobs)),
                  f"msm {label} != the host sum")
        return pts, digits, b, s, p_ms

    def fold_hold(label, C, xs, oracle_rows=None):
        got, p_ms = hold(f"fold {label}: [3, 12, {C.shape[2]}, {C.shape[3]}] at {len(xs)} points "
                         f"(nbits {max(xs).bit_length()})",
                         lambda: vt.fold_points_batch(C, xs),
                         lambda: vt.fold_points_batch(C, xs, use_kernel=False))
        if oracle_rows is not None:
            host = limbs.limbs_to_points(got.cpu().numpy())
            commit = dkg.BivarCommitment(oracle_rows)
            K = C.shape[3]
            for i in (0, len(xs) - 1):
                want = commit.row_commitment(xs[i])
                check(all(bls.eq(a, b) for a, b in zip(host[i * K:(i + 1) * K], want)),
                      f"fold {label} != the host row fold at x = {xs[i]}")
        return p_ms

    # -- 21. the MSM plane on B2 against its plain version ------------------
    t_new = (nodes - 2) // 3  # the survivors' threshold
    pool = g1_pool(64, 21)
    inf = bls.infinity(bls.FQ)
    rng = np.random.default_rng(21)

    def r64(n):
        return [int.from_bytes(rng.bytes(8), "little") | 1 for _ in range(n)]

    def rfull(n):
        return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]

    top64 = (1 << 63) | 0x5DEECE66D
    msm_hold("identity lanes (infinity points, zero scalars, an empty job)",
             [([inf, pool[1], inf, pool[2]], [top64, 5, 3, 0]), ([inf], [top64]),
              ([pool[3], pool[4]], [0, 0]), ([], [])], oracle=True)
    msm_hold("a batch of one", [(pool[5:11], [top64] + r64(5))], oracle=True)
    msm_hold("identity lanes, GLV tier", [([inf, pool[6]], [R - 1, 0]), ([], []),
                                          (pool[7:10], rfull(3))], oracle=True)
    # row checks at t + 1 = 6 terms, the 16-node set's (phase 23 replays the
    # shapes the switch among the 15 survivors records)
    s = (nodes - 1) // 3 + 1
    for b in (nodes - 1, (nodes - 1) ** 2):
        jobs = [([pool[(i * s + k) % 64] for k in range(s)], r64(s)) for i in range(b)]
        msm_hold(f"row checks ({b} jobs x {s}, 64-bit)", jobs, oracle=b == nodes - 1)

    # -- 22. the commitment folds on B2 against their plain version ----------
    def matrix(J, K, seed, inf_at=()):
        g = np.random.default_rng(seed)
        m = [[bls.mul_sub(bls.G1, int.from_bytes(g.bytes(16), "little") | 1) for _ in range(K)]
             for _ in range(J)]
        for j, k in inf_at:
            if j < J and k < K:
                m[j][k] = inf
        C = torch.from_numpy(limbs.points_to_limbs([p for row in m for p in row])).to(dev)
        return m, C.reshape(3, limbs.N_LIMBS, J, K)

    for J, M_, label in ((6, 16, "(6, 6, 16, 5)"), (t_new + 1, nodes - 1, "the switch's")):
        m, C = matrix(J, J, J, inf_at=[(0, 0), (J - 1, 1)])
        fold_hold(f"{label} with infinity entries", C, list(range(1, M_ + 1)), oracle_rows=m)
    # the chain's collision: row 0 = x * row 1 meets acc == C[j] at x
    x = 5
    top = [bls.mul_sub(bls.G1, k) for k in (0x1234567, 0x7654321)]
    coll = [[bls.mul_sub(p, x) for p in top], top]
    Cc = torch.from_numpy(limbs.points_to_limbs([p for row in coll for p in row])).to(dev)
    fold_hold("collision x * acc == C[j]", Cc.reshape(3, limbs.N_LIMBS, 2, 2), [x, 3, 7],
              oracle_rows=coll)

    # -- 23. the era switch on the card against the host engine --------------
    gpu = GpuEngine(device=dev)
    era_switch(gpu, 4, tpu_dkg=True)  # warm-up: the library's first launches at 4 nodes
    reg = M.default_registry()
    names = (M.MSM_REAL_LANES, M.MSM_PAD_LANES, M.MSM_COALESCE_FLUSHES,
             M.MSM_COALESCE_SUBMISSIONS)

    def zero_counts():
        zero_launches(dev)
        limbs.to_points_s = 0.0
        return {k: reg.counter(k).value for k in names}

    host, host_m, host_s = era_switch("cpu", nodes, tpu_dkg=False)
    want = dhb_record(host, host_m)
    before = zero_counts()
    card, card_m, card_s = era_switch(gpu, nodes, tpu_dkg=True)
    torch.cuda.synchronize()
    by_kind = dict(fq_torch.launches_by_kind)
    others = {"gf256_matmul": gf256_torch.launches, "fq2_point": fq2_torch.launches,
              "circuit": circuit_torch.launches, "fp_probe": fp_probe_torch.launches}
    msm_calls, fold_calls = dict(msm_torch.calls), dict(vt.calls)
    key_calls = dict(dkg.channel_key_calls)
    to_points_ms = 1e3 * limbs.to_points_s
    lanes = {k: reg.counter(k).value - before[k] for k in names}
    width = reg.gauge(M.MSM_COALESCE_WIDTH).high_water
    got = dhb_record(card, card_m)
    check(got == want, "the era switch on the card != the host engine's run (batches, eras, "
                       "key sets, validators, counts or faults differ)")
    survivors = card.ids[:-1]
    check(all(got["validators"][nid] == tuple(survivors) for nid in card.ids),
          "the new validator set is not the survivors")
    check(card_m.agreement_ok, "era switch: agreement failed")
    for entry in ("windowed_ladder", "glv_ladder", "add", "dbl", "ladd"):
        check(by_kind.get(entry, 0) > 0, f"the era switch launched B2's {entry} no time: {by_kind}")
    check(msm_calls and fold_calls and key_calls,
          f"the era switch ran no MSM ({msm_calls}), fold ({fold_calls}) or channel-key "
          f"({key_calls}) batch on the device")
    check(sum(others.values()) == 0, f"the era switch launched other kernels: {others}")
    msm_launches = sum(n * msm_torch.launches(b, s) for (b, s, _w), n in msm_calls.items())
    fold_launches = sum(n * vt.launches(J, xs) for (J, _K, xs), n in fold_calls.items())
    key_launches = sum(key_calls.values())
    check(msm_launches + fold_launches + key_launches == sum(by_kind.values()),
          f"B2 launches {sum(by_kind.values())} != msm {msm_launches} + folds {fold_launches} + "
          f"channel keys {key_launches}")
    print(f"main path: the DHB era switch ({nodes} nodes, seed {DKG_SEED}, {DKG_TXNS} x 2-byte "
          f"txns, removal of {card.ids[-1]}) on the card == the host engine: every node's batches "
          f"byte-identical, eras {sorted(set(got['eras'].values()))}, equal key sets, "
          f"{card_m.messages_delivered} messages, {card_m.faults} faults; B2 launches by entry "
          f"{by_kind} (MSMs {msm_launches}, folds {fold_launches}, channel keys {key_launches})")
    jobs = sum(b * n for (b, _s, _w), n in msm_calls.items())
    print(f"MSM plane: {sum(msm_calls.values())} batches, {jobs} jobs, lanes real "
          f"{lanes[M.MSM_REAL_LANES]} / padding {lanes[M.MSM_PAD_LANES]}; coalescer "
          f"{lanes[M.MSM_COALESCE_SUBMISSIONS]} submissions in {lanes[M.MSM_COALESCE_FLUSHES]} "
          f"flushes, widest {width}; by shape (B, S, digit rows) {msm_calls}; folds {len(fold_calls)} "
          f"shapes x {sum(fold_calls.values())}; channel-key batches by lanes {key_calls}; host "
          f"{to_points_ms:.1f} ms in limbs_to_points")

    # in turns: host, card (counted, above), card, host
    walls = {"gpu": [card.epoch_durations], "cpu": [host.epoch_durations]}
    for spec, flag in ((gpu, True), ("cpu", False)):
        again, again_m, _s = era_switch(spec, nodes, tpu_dkg=flag)
        check(dhb_record(again, again_m) == want, "the era switch again != the host engine's run")
        walls["gpu" if flag else "cpu"].append(again.epoch_durations)
    print(f"era switch, wall s per epoch in turns (cpu, gpu, gpu, cpu): "
          f"gpu {[[round(d, 3) for d in w] for w in walls['gpu']]}, "
          f"cpu {[[round(d, 3) for d in w] for w in walls['cpu']]}; whole runs gpu {card_s:.2f} s, "
          f"cpu {host_s:.2f} s {tag}")

    # every recorded shape, exact against the plain version, then its device
    # time back to back behind a spin kernel times its count
    shapes = []
    dev_ms = plain_ms = ops_ms = bytes_ms = 0.0
    for (b, s, w), n in sorted(msm_calls.items()):
        scal = r64 if w < 33 else rfull
        jobs = [([pool[(i * s + k) % 64] for k in range(s)], scal(s)) for i in range(b)]
        pts, digits, b_, s_, p_ms = msm_hold(f"the run's ({b}, {s}, {w})", jobs, oracle=False)
        ms = launch_ms(lambda: msm_torch.msm(pts, digits, b_, s_), reps=3)
        d = digits.cpu().numpy()
        plan = (bls_torch.glv_plan(d) + [row for row in bls_torch.weighted_sum_plan(
            np.zeros((1, b * s), np.int32), s) if row.part == "tree"]) if w == 33 else \
            bls_torch.weighted_sum_plan(d, s)
        o, by = plan_bound(plan)
        shapes.append({"what": "msm", "shape": [b, s, w], "count": n, "ms": ms, "plain_ms": p_ms,
                       "launches": msm_torch.launches(b, s), "bound_ms": max(o, by)})
        dev_ms, plain_ms, ops_ms, bytes_ms = (dev_ms + n * ms, plain_ms + n * p_ms,
                                              ops_ms + n * o, bytes_ms + n * by)
    for (J, K, xs), n in sorted(fold_calls.items()):
        m, C = matrix(J, K, J * 7 + K)
        p_ms = fold_hold(f"the run's ({J}, {K}, {len(xs)})", C, list(xs))
        ms = launch_ms(lambda: vt.fold_points_batch(C, list(xs)), reps=3)
        o, by = plan_bound(fold_plan(J, K, xs))
        shapes.append({"what": "fold", "shape": [J, K, len(xs)], "count": n, "ms": ms,
                       "plain_ms": p_ms, "launches": vt.launches(J, xs), "bound_ms": max(o, by)})
        dev_ms, plain_ms, ops_ms, bytes_ms = (dev_ms + n * ms, plain_ms + n * p_ms,
                                              ops_ms + n * o, bytes_ms + n * by)
    # the channel-key batches: one exact hold of every recorded batch side by
    # side (lanes are independent, so each batch's own launch must equal its
    # slice), each batch's launch timed at its own lane count
    key_ops = [(lanes_n, n, *bls_torch.scalar_mul_operands(pool[:lanes_n], rfull(lanes_n), dev))
               for lanes_n, n in sorted(key_calls.items())]
    cat_pts = torch.cat([p for _l, n, p, _d in key_ops for _ in range(n)], -1)
    cat_digits = torch.cat([d for _l, n, _p, d in key_ops for _ in range(n)], -1)
    whole, p_ms = hold(f"channel keys: glv_ladder x {cat_pts.shape[-1]} (every recorded batch "
                       f"side by side)", lambda: bls_torch.g1_scalar_mul_glv(cat_pts, cat_digits),
                       lambda: bls_torch.g1_scalar_mul_glv(cat_pts, cat_digits, use_kernel=False))
    plain_ms += p_ms
    off = 0
    for lanes_n, n, pts_k, digits_k in key_ops:
        got = bls_torch.g1_scalar_mul_glv(pts_k, digits_k)
        check(torch.equal(got, whole[..., off:off + lanes_n]),
              f"glv_ladder x {lanes_n} != its lanes of the side-by-side launch")
        off += n * lanes_n
        ms = launch_ms(lambda: bls_torch.g1_scalar_mul_glv(pts_k, digits_k), reps=3)
        o, by = plan_bound(bls_torch.glv_plan(digits_k.cpu().numpy()))
        shapes.append({"what": "channel keys", "shape": [lanes_n], "count": n, "ms": ms,
                       "plain_ms": None, "launches": 1, "bound_ms": max(o, by)})
        dev_ms, ops_ms, bytes_ms = dev_ms + n * ms, ops_ms + n * o, bytes_ms + n * by
    print(f"kernel == its side-by-side launch, exact: channel keys at {sorted(key_calls)} lanes "
          f"(plain: one call over all {cat_pts.shape[-1]} lanes, {p_ms:.0f} ms)")
    bound, bound_by = roofline.bound_ms(ops_ms, bytes_ms)
    switch_wall = sum(card.epoch_durations[1:-2])
    print(f"the switch's B2 work replayed at its {len(shapes)} recorded shapes: {dev_ms:.3f} device "
          f"ms ({100 * dev_ms / 1e3 / switch_wall:.2f}% of the {switch_wall:.2f} s of switch epochs on "
          f"the card), plain {plain_ms:.1f} ms, bound {bound:.5f} ms ({bound_by}), "
          f"{dev_ms / bound:.0f}x {tag}")
    print(json.dumps({"dhb": {"shapes": shapes, "launches_by_entry": by_kind, "lanes": lanes,
                              "coalesce_width": width, "walls": walls, "to_points_ms": to_points_ms,
                              "card": tag}}))
    return {
        "per": f"the DHB era switch ({nodes} nodes, config 5's Python-core leg): every recorded "
               f"MSM, fold and channel-key shape timed back to back, times its count",
        "launches": sum(by_kind.values()),
        "launches_by_entry": by_kind,
        "ms": dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "max_abs_err": worst,
        "host_to_points_ms": to_points_ms,
        "gpu_epoch_s": walls["gpu"],
        "cpu_epoch_s": walls["cpu"],
    }


def tcp_testnet(engine: str, batches: int, cap_s: float, base: int, **cfg_kw):
    """Config 1 (bench.py:390-462): a 4-node testnet on localhost sockets in
    this process, seeds 1000 + i, every node dialling the others, with
    bench.py's transaction generator, until every node has committed
    `batches` batches or `cap_s` passed.  Returns (nodes, wall s)."""
    import asyncio

    from hydrabadger_tpu_torch.net.node import Config, Hydrabadger
    from hydrabadger_tpu_torch.utils.ids import InAddr, OutAddr

    n = 4
    cfg = Config(txn_gen_interval_ms=300, keygen_peer_count=n - 1, engine=engine, **cfg_kw)

    async def run():
        nodes = [Hydrabadger(InAddr("127.0.0.1", base + i), cfg, seed=1000 + i) for i in range(n)]
        gen = lambda count, size: [b"%02dx" % i * size for i in range(count)]  # noqa: E731
        for i, node in enumerate(nodes):
            await node.start([OutAddr("127.0.0.1", base + j) for j in range(n) if j != i], gen)
        t0 = time.perf_counter()
        while min(len(node.batches) for node in nodes) < batches:
            if time.perf_counter() - t0 > cap_s:
                break
            await asyncio.sleep(0.02)
        wall = time.perf_counter() - t0
        for node in nodes:
            await node.stop()
        return nodes, wall

    return asyncio.run(run())


def testnet_checks(nodes, batches: int, what: str) -> None:
    """Every node committed `batches` batches, all nodes agree on them, and
    every contribution is a decrypted generator payload (a codec tuple of
    bench.py's `%02dx` transactions)."""
    from hydrabadger_tpu_torch.utils import codec

    got = [len(n.batches) for n in nodes]
    check(min(got) >= batches, f"{what}: batches committed {got}, want {batches} on every node "
                               "within the wall cap")
    for e in range(batches):
        keys = {(n.batches[e].epoch, tuple(sorted((bytes(k), bytes(v)) for k, v in
                                                  n.batches[e].contributions.items())))
                for n in nodes}
        check(len(keys) == 1, f"{what}: the nodes disagree on batch {e}")
        for payload in nodes[0].batches[e].contributions.values():
            txns = codec.decode(bytes(payload))
            check(isinstance(txns, tuple) and txns and all(
                re.fullmatch(rb"(\d\dx)+", bytes(t)) for t in txns),
                f"{what}: batch {e} holds a contribution that did not decrypt to the generator's "
                f"transactions: {bytes(payload)[:40]!r}")


def recording_gpu_engine(dev):
    """A GpuEngine on `dev` that records each verify_batch call that reached
    the card (its items and verdicts) and each r_i * pk_i batch, registered
    as the engine "gpu-recording"; returns its class (the records are class
    lists)."""
    import functools

    from hydrabadger_tpu_torch.crypto import engine as teng

    class RecordingGpuEngine(teng.GpuEngine):
        verifies: list = []
        muls: list = []

        def verify_batch(self, items):
            before = len(self.muls)
            verdicts = super().verify_batch(items)
            if len(self.muls) > before:
                self.verifies.append((list(items), list(verdicts)))
            return verdicts

        def _g1_scalar_muls(self, points, scalars):
            out = super()._g1_scalar_muls(points, scalars)
            self.muls.append((list(points), list(scalars), out))
            return out

    teng.register_engine("gpu-recording", functools.partial(RecordingGpuEngine, device=dev))
    return RecordingGpuEngine


def replay_on_the_host(verifies, muls, all_pass: bool = True) -> None:
    """Every verify_batch verdict from the card replayed on the host engine,
    every r_i * pk_i against the native ladder; with `all_pass` (no frame
    was forged) every frame passed."""
    from hydrabadger_tpu_torch.crypto import bls12_381 as bls
    from hydrabadger_tpu_torch.crypto import engine as teng
    from hydrabadger_tpu_torch.crypto import native_bls as nb

    for items_, verdicts in verifies:
        teng._VERIFIED_FRAMES.clear()
        check(teng.CpuEngine().verify_batch(items_) == verdicts,
              "a verify_batch verdict on the card != the host engine's replay")
    for pts, rs, out in muls:
        check([bls.g1_to_bytes(p) for p in out] == [bls.g1_to_bytes(p) for p in
                                                   nb.g1_mul_batch(pts, rs)],
              f"r_i * pk_i from B2 ({len(pts)} lanes) != native g1_mul_batch")
    teng._VERIFIED_FRAMES.clear()
    check(not all_pass or all(all(v) for _i, v in verifies),
          "an honest testnet frame failed verification")


def tcp_plane(dev: torch.device, tag: str) -> tuple[dict, dict, int]:
    """Phases 24-26: the native host library against its pure oracle, kernel
    B2's GLV ladder at verify_batch's shapes, and config 1 (the 4-node TCP
    testnet at full crypto) on GpuEngine against the host engine, then a
    fast-tier low-comm leg.  Returns kernel B2's and kernel B1's records
    for the `kernels` line and the worst error of the holds."""
    from hydrabadger_tpu_torch.crypto import bls12_381 as bls
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto import engine as teng
    from hydrabadger_tpu_torch.crypto import native_bls as nb
    from hydrabadger_tpu_torch.crypto import threshold as th
    from hydrabadger_tpu_torch.obs import metrics as M
    from hydrabadger_tpu_torch.ops import bls_torch, circuit_torch, fp_probe_torch, fq2_torch
    from hydrabadger_tpu_torch.ops import fq_torch, gf256_torch, homhash_torch, limbs, msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt

    R = bls.R
    worst = 0
    rng = np.random.default_rng(24)

    def aff(p):
        return bls.g1_to_bytes(p) if isinstance(p[0], bls.FQ) else bls.g2_to_bytes(p)

    # -- 24. the native host library against the pure-Python oracles ---------
    t0 = time.perf_counter()
    g1 = [bls._py_multiply(bls.G1, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(3)]
    g2 = [bls._py_hash_to_g2(b"smoke-%d" % i) for i in range(2)]
    inf1, inf2 = bls.infinity(bls.FQ), bls.infinity(bls.FQ2)
    ks = [0, 1, R - 1, int.from_bytes(rng.bytes(32), "little") % R]
    for base, name in ((g1[0], "g1"), (g2[0], "g2")):
        for k in ks:
            want = aff(bls._py_multiply(base, k))
            check(aff(bls.multiply(base, k)) == want == aff(bls.mul_sub(base, k)),
                  f"native {name} multiply != _py_multiply at k = {k}")
    for p, q in ((g1[0], g1[1]), (g1[0], g1[0]), (g1[0], bls.neg(g1[0])), (inf1, g1[2]),
                 (g2[0], g2[1]), (g2[0], inf2)):
        check(aff(bls.add(p, q)) == aff(bls._py_add(p, q)), "native add != _py_add")
    lam = th.lagrange_coeffs_at_zero([1, 2, 3])
    want = inf1
    for p, li in zip(g1, lam):
        want = bls._py_add(want, bls._py_multiply(p, li))
    check(aff(th.interpolate_g_at_zero(dict(zip([1, 2, 3], g1)))) == aff(want),
          "native weighted sum != the pure interpolation")
    check(aff(nb.g1_msm(g1, lam)) == aff(want), "native MSM != the pure sum")
    fold = nb.g1_fold_pow([g1[:2], [g1[2], inf1]], 5, 0)
    check([aff(p) for p in fold] == [aff(bls._py_add(g1[0], bls._py_multiply(g1[2], 5))), aff(g1[1])],
          "native fold != the pure Horner fold")
    for p in g1 + [inf1]:
        check(aff(bls.g1_from_bytes(bls.g1_to_bytes(p))) == aff(p), "native G1 decompression")
    for p in g2:
        check(aff(bls.g2_from_bytes(bls.g2_to_bytes(p))) == aff(p), "native G2 decompression")
    y = (bls.FQ(0) * bls.FQ(0) * bls.FQ(0) + bls.B1).sqrt()
    check(not bls.in_g1_subgroup((bls.FQ(0), y, bls.FQ(1))) and bls.in_g2_subgroup(g2[0]),
          "native subgroup checks")
    p1, q1 = bls._py_multiply(bls.G1, 35), bls._py_multiply(bls.G2, 11)
    for k in (385, 386):
        p2 = bls._py_multiply(bls.G1, k)
        check(bls.pairing_check_eq(p1, q1, p2, bls.G2) == bls._py_pairing_check_eq(p1, q1, p2, bls.G2)
              == (k == 385), "native pairing_check_eq != the pure check")
    pairs = [(bls.neg(p1), q1), (bls._py_multiply(bls.G1, 385), bls.G2)]
    check(bls.pairing_product_check(pairs) and bls._py_pairing_product_check(pairs),
          "native pairing_product_check != the pure check")
    for msg in (b"", b"config 1"):
        check(aff(nb.hash_to_g2(msg, b"HBTPU-G2")) == aff(bls._py_hash_to_g2(msg)),
              "native hash_to_g2 != the pure hash")
    print(f"native host library == the pure-Python oracles: multiply / mul_sub (G1, G2, k in 0, 1, "
          f"r - 1, random), add (P + Q, P + P, P - P, infinity), the weighted sum, the MSM, the fold, "
          f"decompression, the subgroup checks, both pairing checks, hash_to_g2 "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 25. B2's GLV ladder at verify_batch's shapes; verify_batch on the card
    pool = [bls.mul_sub(bls.G1, int(k) | 1) for k in rng.integers(1, 2**62, 64)]
    for lanes in (2, 3, 8, 50, RAGGED):
        pts = [pool[i % 64] for i in range(lanes)]
        rs = [int.from_bytes(rng.bytes(16), "little") | 1 for _ in range(lanes)]
        pts_t, digits = bls_torch.scalar_mul_operands(pts, rs, dev)
        got = bls_torch.g1_scalar_mul_glv(pts_t, digits)
        want = bls_torch.g1_scalar_mul_glv(pts_t, digits, use_kernel=False)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, want))
        check(torch.equal(got, want), f"glv_ladder != plain at {lanes} lanes")
        host = nb.g1_mul_batch(pts, rs)
        check([aff(p) for p in bls_torch.to_host(got)] == [aff(p) for p in host],
              f"glv_ladder x {lanes} != native g1_mul_batch")
    print(f"kernel == plain, exact, and == native g1_mul_batch: glv_ladder at 2, 3, 8, 50 and "
          f"{RAGGED} lanes (128-bit RLC coefficients)")
    sks = [th.SecretKey(int.from_bytes(rng.bytes(31), "little") | 1) for _ in range(12)]
    items = [(sk.public_key(), sk.sign(b"frame %d" % i), b"frame %d" % i) for i, sk in enumerate(sks)]
    items[7] = (items[7][0], sks[1].sign(b"frame 7"), b"frame 7")  # forged
    items.append(items[3])  # a duplicate
    teng._VERIFIED_FRAMES.clear()
    want_v = teng.CpuEngine().verify_batch(items)
    teng._VERIFIED_FRAMES.clear()
    got_v = teng.GpuEngine(device=dev).verify_batch(items)
    check(got_v == want_v == [i != 7 for i in range(13)],
          f"verify_batch on the card {got_v} != the host engine's {want_v}")
    print("verify_batch on the card == the host engine: 13 frames, one forged, one duplicate")

    # -- 26. config 1: the 4-node TCP testnet at full crypto ----------------
    RecordingGpuEngine = recording_gpu_engine(dev)
    reg = M.default_registry()
    names = (M.VERIFY_DEVICE_BATCHES, M.VERIFY_DEVICE_LANES, M.VERIFY_TO_POINTS_MS)
    ports = iter(range(15300, 15400, 4))

    def run(engine, gpu_dkg: bool):
        os.environ[dkg.GPU_DKG_ENV] = "1" if gpu_dkg else "0"
        dkg.clear_caches()
        teng._VERIFIED_FRAMES.clear()
        try:
            nodes, wall = tcp_testnet(engine, 2, 300.0, next(ports))
        finally:
            os.environ.pop(dkg.GPU_DKG_ENV, None)
        testnet_checks(nodes, 2, f"config 1 on the {engine} engine")
        return nodes, wall

    def zero_counts():
        zero_launches(dev)
        RecordingGpuEngine.verifies.clear()
        RecordingGpuEngine.muls.clear()
        limbs.to_points_s = 0.0
        return {k: reg.counter(k).value for k in names}

    run("gpu-recording", True)  # warm-up
    walls = {"gpu": [], "cpu": []}
    _nodes, w = run("cpu", False)
    walls["cpu"].append(w)
    before = zero_counts()
    card_nodes, w = run("gpu-recording", True)
    torch.cuda.synchronize()
    walls["gpu"].append(w)
    by_kind = dict(fq_torch.launches_by_kind)
    others = {"gf256_matmul": gf256_torch.launches, "fq2_point": fq2_torch.launches,
              "circuit": circuit_torch.launches, "fp_probe": fp_probe_torch.launches}
    msm_calls, fold_calls = dict(msm_torch.calls), dict(vt.calls)
    key_calls, lane_hist = dict(dkg.channel_key_calls), dict(teng.device_verify_calls)
    verifies, muls = list(RecordingGpuEngine.verifies), list(RecordingGpuEngine.muls)
    counted = {k: reg.counter(k).value - before[k] for k in names}
    to_points_ms = 1e3 * limbs.to_points_s
    for engine, flag, key in (("gpu-recording", True, "gpu"), ("cpu", False, "cpu")):
        walls[key].append(run(engine, flag)[1])
    check(len(muls) == counted[M.VERIFY_DEVICE_BATCHES] == sum(lane_hist.values()) > 0,
          f"config 1 sent {len(muls)} verify batches to the card (counted "
          f"{counted[M.VERIFY_DEVICE_BATCHES]}, histogram {lane_hist}); want the same number, > 0")
    replay_on_the_host(verifies, muls)
    check(sum(others.values()) == 0, f"config 1 launched other kernels: {others}")
    check(by_kind.get("glv_ladder", 0) >= len(muls), f"B2 launches by entry {by_kind}")
    msm_launches = sum(n * msm_torch.launches(b, s) for (b, s, _w), n in msm_calls.items())
    fold_launches = sum(n * vt.launches(J, xs) for (J, _K, xs), n in fold_calls.items())
    key_launches = sum(key_calls.values())
    check(len(muls) + msm_launches + fold_launches + key_launches == sum(by_kind.values()),
          f"B2 launches {sum(by_kind.values())} != verify batches {len(muls)} + msm {msm_launches} "
          f"+ folds {fold_launches} + channel keys {key_launches}")
    check(msm_launches + fold_launches + key_launches > 0, "the bootstrap DKG launched nothing on B2")
    eps = {k: [round(2 / x, 4) for x in v] for k, v in walls.items()}
    print(f"main path: config 1 (4-node TCP testnet, full crypto, txn_gen_interval_ms 300, "
          f"keygen_peer_count 3, seeds 1000 + i) to 2 agreed, decrypted batches on every node on "
          f"GpuEngine with the DKG plane forced and on the host engine; {len(verifies)} verify_batch "
          f"calls on the card replayed on the host engine with equal verdicts, every r_i * pk_i equal "
          f"to native g1_mul_batch; B2 launches by entry {by_kind} (verify batches {len(muls)}, MSMs "
          f"{msm_launches}, folds {fold_launches}, channel keys {key_launches}), no other kernel")
    print(f"config 1 verify batches on the card: {len(muls)}, lanes {counted[M.VERIFY_DEVICE_LANES]}, "
          f"lane histogram {dict(sorted(lane_hist.items()))}; host {to_points_ms:.1f} ms in "
          f"limbs_to_points (verify batches {counted[M.VERIFY_TO_POINTS_MS]:.1f} ms)")
    print(f"config 1 wall epochs/s (2 batches from start, bootstrap DKG included) in turns (cpu, gpu, "
          f"gpu, cpu): gpu engine {eps['gpu']}, cpu engine {eps['cpu']}; wall s gpu "
          f"{[round(x, 2) for x in walls['gpu']]}, cpu {[round(x, 2) for x in walls['cpu']]} {tag}")

    # B2's device time in the counted run: every recorded verify batch side
    # by side held exact, then each lane count's launch and each DKG shape
    # timed back to back, times its count
    cat_pts, cat_digits = bls_torch.scalar_mul_operands(
        [p for pts, _r, _o in muls for p in pts], [r for _p, rs, _o in muls for r in rs], dev)
    t0 = time.perf_counter()
    whole = bls_torch.g1_scalar_mul_glv(cat_pts, cat_digits)
    want = bls_torch.g1_scalar_mul_glv(cat_pts, cat_digits, use_kernel=False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(worst, max_abs_err(whole, want))
    check(torch.equal(whole, want), f"glv_ladder != plain over config 1's {cat_pts.shape[-1]} verify lanes")
    dev_ms = ops_ms = bytes_ms = 0.0
    shapes = []
    first = {}
    for pts, rs, _o in muls:
        first.setdefault(len(pts), (pts, rs))
    for lanes, n in sorted(lane_hist.items()):
        pts_t, digits = bls_torch.scalar_mul_operands(*first[lanes], dev)
        ms = launch_ms(lambda: bls_torch.g1_scalar_mul_glv(pts_t, digits), reps=5)
        o, by = plan_bound(bls_torch.glv_plan(digits.cpu().numpy()))
        shapes.append({"what": "verify", "lanes": lanes, "count": n, "ms": ms, "bound_ms": max(o, by)})
        dev_ms, ops_ms, bytes_ms = dev_ms + n * ms, ops_ms + n * o, bytes_ms + n * by
    for (b, s, w), n in sorted(msm_calls.items()):
        jobs = [([pool[(i * s + k) % 64] for k in range(s)],
                 [int.from_bytes(rng.bytes(32 if w == 33 else 8), "little") % R for _ in range(s)])
                for i in range(b)]
        pts_t, digits, b_, s_ = msm_torch.operands(jobs, dev)
        got = msm_torch.msm(pts_t, digits, b_, s_)
        check(torch.equal(got, msm_torch.msm(pts_t, digits, b_, s_, use_kernel=False)),
              f"msm != plain at config 1's ({b}, {s}, {w})")
        ms = launch_ms(lambda: msm_torch.msm(pts_t, digits, b_, s_), reps=3)
        d = digits.cpu().numpy()
        plan = (bls_torch.glv_plan(d) + [row for row in bls_torch.weighted_sum_plan(
            np.zeros((1, b * s), np.int32), s) if row.part == "tree"]) if w == 33 else \
            bls_torch.weighted_sum_plan(d, s)
        o, by = plan_bound(plan)
        shapes.append({"what": "msm", "shape": [b, s, w], "count": n, "ms": ms, "bound_ms": max(o, by)})
        dev_ms, ops_ms, bytes_ms = dev_ms + n * ms, ops_ms + n * o, bytes_ms + n * by
    for (J, K, xs), n in sorted(fold_calls.items()):
        C = torch.from_numpy(limbs.points_to_limbs([pool[i % 64] for i in range(J * K)])).to(dev)
        C = C.reshape(3, limbs.N_LIMBS, J, K)
        got = vt.fold_points_batch(C, list(xs))
        check(torch.equal(got, vt.fold_points_batch(C, list(xs), use_kernel=False)),
              f"fold != plain at config 1's ({J}, {K}, {len(xs)})")
        ms = launch_ms(lambda: vt.fold_points_batch(C, list(xs)), reps=3)
        o, by = plan_bound(fold_plan(J, K, xs))
        shapes.append({"what": "fold", "shape": [J, K, len(xs)], "count": n, "ms": ms,
                       "bound_ms": max(o, by)})
        dev_ms, ops_ms, bytes_ms = dev_ms + n * ms, ops_ms + n * o, bytes_ms + n * by
    for lanes, n in sorted(key_calls.items()):
        pts_t, digits = bls_torch.scalar_mul_operands(
            pool[:lanes], [int.from_bytes(rng.bytes(32), "little") % R for _ in range(lanes)], dev)
        ms = launch_ms(lambda: bls_torch.g1_scalar_mul_glv(pts_t, digits), reps=5)
        o, by = plan_bound(bls_torch.glv_plan(digits.cpu().numpy()))
        shapes.append({"what": "channel keys", "lanes": lanes, "count": n, "ms": ms,
                       "bound_ms": max(o, by)})
        dev_ms, ops_ms, bytes_ms = dev_ms + n * ms, ops_ms + n * o, bytes_ms + n * by
    bound, bound_by = roofline.bound_ms(ops_ms, bytes_ms)
    verify_ms = sum(x["count"] * x["ms"] for x in shapes if x["what"] == "verify")
    print(f"config 1's B2 work replayed at its {len(shapes)} recorded shapes: {dev_ms:.3f} device ms "
          f"per run (verify batches {verify_ms:.3f} ms, {100 * dev_ms / 1e3 / walls['gpu'][0]:.3f}% of "
          f"the {walls['gpu'][0]:.2f} s counted run), bound {bound:.5f} ms ({bound_by}), "
          f"{dev_ms / bound:.0f}x; plain over all {cat_pts.shape[-1]} verify lanes {plain_ms:.0f} ms {tag}")
    print(json.dumps({"tcp_config1": {"shapes": shapes, "launches_by_entry": by_kind,
                                      "lane_histogram": lane_hist, "walls": walls, "card": tag}}))
    b2 = {
        "per": "config 1: the 4-node TCP testnet at full crypto to 2 batches on every node "
               "(verify_batch's r_i * pk_i and the bootstrap DKG's MSMs, folds and channel keys), "
               "every recorded shape timed back to back, times its count",
        "launches": sum(by_kind.values()),
        "launches_by_entry": by_kind,
        "verify_batches": len(muls),
        "verify_lanes": counted[M.VERIFY_DEVICE_LANES],
        "lane_histogram": {str(k): v for k, v in sorted(lane_hist.items())},
        "ms": dev_ms,
        "verify_ms": verify_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "max_abs_err": worst,
        "host_to_points_ms": to_points_ms,
        "gpu_epochs_per_s": eps["gpu"],
        "cpu_epochs_per_s": eps["cpu"],
    }

    # -- 26b. the fast tier with the low-comm broadcast: B1's sketches -------
    homhash_torch.calls.clear()
    zero_counts()
    os.environ[dkg.GPU_DKG_ENV] = "0"  # B1 only: the 4-node DKG stays on the host
    try:
        nodes, w = tcp_testnet("gpu", 2, 300.0, next(ports), encrypt=False, coin_mode="hash",
                               verify_shares=False, wire_sign=False, rbc_variant="lowcomm")
    finally:
        os.environ.pop(dkg.GPU_DKG_ENV, None)
    torch.cuda.synchronize()
    launched = {"gf256_matmul": gf256_torch.launches, "fq_point": fq_torch.launches,
                "fq2_point": fq2_torch.launches, "circuit": circuit_torch.launches,
                "fp_probe": fp_probe_torch.launches}
    implied = sum(n * len(gf256_torch.chunks(8, L)) for (_b, L), n in homhash_torch.calls.items())
    testnet_checks(nodes, 2, "the low-comm fast-tier testnet")
    check(launched["gf256_matmul"] == implied > 0 and sum(launched.values()) == implied,
          f"the low-comm testnet's launches {launched} != the {implied} its sketch calls imply")
    print(f"main path: the 4-node TCP testnet, fast tier, rbc lowcomm, on GpuEngine: 2 agreed "
          f"batches on every node in {w:.2f} s; B1 launches {launched['gf256_matmul']} == the sketch "
          f"calls' {implied}, no other kernel {tag}")
    b1 = {"per": "the 4-node TCP testnet, fast tier, rbc lowcomm, to 2 batches",
          "launches": launched["gf256_matmul"], "wall_s": w}
    return b2, b1, worst


def graph_ms(fn, reps: int = 5):
    """(device ms per call, the call's result) of fn captured once in a CUDA
    graph and replayed between CUDA events: the call's kernels back to back
    with no host gap, however many launches it makes (the median of
    `reps` replays; the result is the last replay's)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on a side stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def pairing_plane(dev: torch.device, tag: str) -> tuple[dict, int]:
    """Phase 27: the batched pairing check on kernel B3 at config 7's
    geometry.  Returns the `pairing` record of kernel B3's entry of the
    `kernels` line and the worst error of the circuit holds."""
    import random

    from hydrabadger_tpu_torch.crypto import bls12_381 as bls
    from hydrabadger_tpu_torch.crypto import threshold as th
    from hydrabadger_tpu_torch.crypto.engine import CpuEngine, GpuEngine
    from hydrabadger_tpu_torch.ops import circuit_torch, fp_probe_torch, fq2_torch, fq_torch
    from hydrabadger_tpu_torch.ops import gf256_torch, limbs
    from hydrabadger_tpu_torch.ops import pairing_torch as pt

    # -- set-up: config 7 (bench.py:705-760) -----------------------------------
    t0 = time.perf_counter()
    rng = random.Random(7)
    sks = th.SecretKeySet.random(1, rng)
    pks = sks.public_keys()
    cts, shares, pk_shares = [], [], []
    for i in range(PAIR_BATCH):
        ct = pks.public_key().encrypt(b"%032d" % i, rng)
        cts.append(ct)
        shares.append(sks.secret_key_share(i % 2).decrypt_share(ct))
        pk_shares.append(pks.public_key_share(i % 2))
    # forged lanes (the other key's share) and one share at infinity
    extra_cts = cts[:PAIR_FORGED + 1]
    extra_shares = [sks.secret_key_share((i + 1) % 2).decrypt_share(ct)
                    for i, ct in enumerate(extra_cts[:PAIR_FORGED])]
    extra_shares.append(th.DecryptionShare(bls.infinity(bls.FQ)))
    extra_pks = pk_shares[:PAIR_FORGED + 1]
    print(f"pairing set-up: config 7, {PAIR_BATCH} ciphertexts and shares (key i % 2), "
          f"{PAIR_FORGED} forged lanes, 1 at infinity: {time.perf_counter() - t0:.2f} s")

    # -- each circuit on B3 against its plain version --------------------------
    worst = 0
    gen = np.random.default_rng(27)
    circs = {**pt.circuits(), "sqr": pt._sqr_circuit()}
    for lanes in (RAGGED, 2 * PAIR_BATCH):
        for name, circ in circs.items():
            ints = [int.from_bytes(gen.bytes(48), "little") % bls.P
                    for _ in range(circ.n_inputs * lanes)]
            for j, v in enumerate((bls.P - 1, bls.P - 2, 0, 1)):
                ints[j * lanes // 4] = v  # edge values, one lane each
            w = limbs.ints_to_limbs_batch(ints).reshape(circ.n_inputs, lanes, 12)
            x = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))).to(dev)
            got, want = circ(x), circ.plain(x)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst = max(worst, err)
            check(torch.equal(got, want), f"B3 {name} != plain at {lanes} lanes (max err {err})")
        print(f"kernel == plain, exact: every pairing circuit ({', '.join(circs)}) at "
              f"[n, 12, {lanes}]")

    # -- the main path: every verdict against the native host check ------------
    gpu, host = GpuEngine(device=dev), CpuEngine()
    all_pks, all_shares, all_cts = (pk_shares + extra_pks, shares + extra_shares,
                                    cts + extra_cts)
    gpu.verify_decryption_share_pairs(all_pks[:4], all_shares[:4], all_cts[:4])  # warm-up
    torch.cuda.synchronize()
    fq_torch.launches, fq2_torch.launches, circuit_torch.launches = 0, 0, 0
    gf256_torch.launches, fp_probe_torch.launches = 0, 0
    circuit_torch.launches_by_circuit.clear()
    verdicts = gpu.verify_decryption_share_pairs(all_pks, all_shares, all_cts)
    torch.cuda.synchronize()
    by_circuit = dict(circuit_torch.launches_by_circuit)
    counted = circuit_torch.launches
    others = fq_torch.launches + fq2_torch.launches + gf256_torch.launches + fp_probe_torch.launches
    want_sched = pt.schedule(len(all_shares) - 1)  # every lane but the one at infinity
    check(by_circuit == want_sched, f"B3 launches by circuit {by_circuit}, pairing_torch's "
                                    f"schedule {want_sched}")
    check(others == 0, f"the pairing batch launched {others} kernels of other libraries")
    print(f"main path: one pairing batch of {len(all_shares)} checks, B3 launches {counted} "
          f"(by circuit {by_circuit}) == pairing_torch.schedule; no other kernel")
    t0 = time.perf_counter()
    oracle = [host.verify_decryption_share(pk, s, ct)
              for pk, s, ct in zip(all_pks, all_shares, all_cts)]
    check(verdicts == oracle, "a verdict != native pairing_check_eq")
    check(all(verdicts[:PAIR_BATCH]) and not any(verdicts[PAIR_BATCH:]),
          "config 7's shares must all pass and the forged and infinity lanes fail")
    print(f"all {len(verdicts)} verdicts == native pairing_check_eq ({PAIR_BATCH} true, "
          f"{PAIR_FORGED} forged and 1 infinity false; host {time.perf_counter() - t0:.2f} s)")
    msgs = [b"coin-%d" % i for i in range(PAIR_SIG)]
    sig_shares = [sks.secret_key_share(i % 2).sign_share(msgs[i] if i % 5 else b"forged")
                  for i in range(PAIR_SIG)]
    sig_pks = [pks.public_key_share(i % 2) for i in range(PAIR_SIG)]
    sig_v = gpu.verify_signature_share_pairs(sig_pks, sig_shares, msgs)
    sig_o = [host.verify_signature_share(pks, i % 2, s, m)
             for i, (s, m) in enumerate(zip(sig_shares, msgs))]
    check(sig_v == sig_o and sum(sig_o) == PAIR_SIG - len(range(0, PAIR_SIG, 5)),
          "a signature-share verdict != native pairing_check_eq")
    print(f"verify_signature_share_pairs: all {PAIR_SIG} verdicts == native pairing_check_eq "
          f"({sum(sig_o)} true)")

    # -- timings ---------------------------------------------------------------
    batch = (pk_shares, shares, cts)
    args = pt.operands([s.point for s in shares], [th._te_hash(ct) for ct in cts],
                       [pk.point for pk in pk_shares], [ct.w for ct in cts], dev)
    check(bool(pt.pairing_eq_kernel(*args).all()), "the timed batch's verdicts")
    eager = pt.pairing_eq_kernel(*args)
    launches_before = circuit_torch.launches
    dev_med, replayed = graph_ms(lambda: pt.pairing_eq_kernel(*args))
    check(circuit_torch.launches - launches_before == 2 * sum(pt.schedule(PAIR_BATCH).values()),
          "the graph's warm-up and capture must launch the schedule once each")
    check(torch.equal(replayed, eager), "the graph's verdicts != the eager batch's")
    kernel_wall = wall_ms(lambda: pt.pairing_eq_kernel(*args))
    # B3 alone: each circuit at its lanes, back to back, times its launches
    per_circuit, b3_ms, plain_ms = {}, 0.0, 0.0
    sched = pt.schedule(PAIR_BATCH)
    for name, count in sched.items():
        circ = circs[name]
        lanes = 2 * PAIR_BATCH if name.startswith("miller") else PAIR_BATCH
        xin = torch.randint(0, 2**31 - 1, (circ.n_inputs, 12, lanes), dtype=torch.int32,
                            device=dev) & 0x0FFFFFFF  # canonical: below 2^380
        ms = launch_ms(lambda: circ(xin))
        p_ms = wall_ms(lambda: circ.plain(xin))
        per_circuit[name] = {"count": count, "lanes": lanes, "products_per_lane": circ.n_products,
                             "layers": len(circ.circ.n_lanes), "warps": circ.slots.warps,
                             "smem": circ.smem, "ms": ms, "plain_ms": p_ms}
        b3_ms += count * ms
        plain_ms += count * p_ms
    ops_ms, bytes_ms = pt.bound(PAIR_BATCH)
    bound, bound_by = roofline.bound_ms(ops_ms, bytes_ms)
    # shares/s wall against the native per-share loop, in turns (native, card,
    # card, native): "cold" clears the hash cache before each turn, "warm"
    # fills it first (bench.py's measured call is its second, warm)
    n_native = min(32, PAIR_BATCH)
    sps = {mode: {"native": [], "gpu": []} for mode in ("cold", "warm")}
    host_split = {"cold": [], "warm": []}
    for mode in ("cold", "warm"):
        if mode == "warm":
            for ct in cts:  # the cache holds every hash from here on
                th._te_hash(ct)
        for turn in ("native", "gpu", "gpu", "native"):
            if mode == "cold":
                bls._hash_cache_clear()
            torch.cuda.synchronize()
            if turn == "native":
                t0 = time.perf_counter()
                for pk, s, ct in zip(pk_shares[:n_native], shares[:n_native], cts[:n_native]):
                    check(host.verify_decryption_share(pk, s, ct), "native per-share check")
                sps[mode]["native"].append(n_native / (time.perf_counter() - t0))
            else:
                pt.host_s.clear()
                t0 = time.perf_counter()
                ok = gpu.verify_decryption_share_pairs(*batch)
                wall = time.perf_counter() - t0
                check(all(ok), "timed batch: a config-7 share failed")
                sps[mode]["gpu"].append(PAIR_BATCH / wall)
                host_split[mode].append({"wall_ms": wall * 1e3,
                                         **{k + "_ms": v * 1e3 for k, v in pt.host_s.items()}})
    gpu_sps, native_sps = sps["warm"]["gpu"], sps["warm"]["native"]
    busy = dev_med / kernel_wall
    print(f"config 7 at {PAIR_BATCH} checks: device {dev_med:.3f} ms per batch by events around "
          f"the batch replayed as a CUDA graph (median of 5), of which B3 {b3_ms:.3f} ms (each "
          f"circuit back to back times its launches), "
          f"{sum(sched.values())} B3 launches; bound {bound:.4f} ms ({bound_by}; "
          f"{pt.products(1)} Fp products a check), {dev_med / bound:.0f}x; pairing_eq_kernel's "
          f"wall {kernel_wall:.1f} ms; plain circuits {plain_ms:.1f} ms {tag}")
    for mode in ("warm", "cold"):
        g, h = sps[mode]["gpu"], sps[mode]["native"]
        print(f"config 7 shares/s wall, hash cache {mode}: card {[round(v, 1) for v in g]}, native "
              f"per-share loop ({n_native} checks) {[round(v, 1) for v in h]}, ratio "
              f"{np.median(g) / np.median(h):.2f}; host split {host_split[mode]} {tag}")
    print(f"card busy {100 * busy:.1f}% of pairing_eq_kernel's wall (device {dev_med:.3f} ms of "
          f"{kernel_wall:.1f} ms) {tag}")
    print(json.dumps({"pairing_circuits": per_circuit, "device_ms": dev_med,
                      "kernel_wall_ms": kernel_wall, "shares_per_s": sps,
                      "host_split": host_split, "ops_bound_ms": ops_ms,
                      "bytes_bound_ms": bytes_ms}))
    return {
        "per": f"one config-7 pairing batch ({PAIR_BATCH} checks): device time by events "
               f"around the batch replayed as a CUDA graph; B3's share of it in b3_ms",
        "launches": counted,
        "launches_by_circuit": by_circuit,
        "ms": dev_med,
        "b3_ms": b3_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "shares_per_s": float(np.median(gpu_sps)),
        "native_shares_per_s": float(np.median(native_sps)),
        "shares_per_s_cold_hash": float(np.median(sps["cold"]["gpu"])),
        "native_shares_per_s_cold_hash": float(np.median(sps["cold"]["native"])),
        "busy_share": busy,
    }, worst


def b2_launches(dev: torch.device) -> tuple[dict, dict]:
    """B2's launches by entry since the counters were last set to 0, and
    every other kernel's count."""
    from hydrabadger_tpu_torch.ops import circuit_torch, fp_probe_torch, fq2_torch, fq_torch
    from hydrabadger_tpu_torch.ops import gf256_torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(fq_torch.launches_by_kind), {
        "gf256_matmul": gf256_torch.launches, "fq2_point": fq2_torch.launches,
        "circuit": circuit_torch.launches, "fp_probe": fp_probe_torch.launches}


def zero_launches(dev: torch.device) -> None:
    """Every kernel's launch counter and the DKG plane's call records to 0."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto import engine as teng
    from hydrabadger_tpu_torch.ops import circuit_torch, fp_probe_torch, fq2_torch, fq_torch
    from hydrabadger_tpu_torch.ops import gf256_torch, msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt

    if dev.type == "cuda":
        torch.cuda.synchronize()
    gf256_torch.launches = fq_torch.launches = fq2_torch.launches = 0
    circuit_torch.launches = fp_probe_torch.launches = 0
    fq_torch.launches_by_kind.clear()
    msm_torch.calls.clear()
    vt.calls.clear()
    dkg.channel_key_calls.clear()
    teng.device_verify_calls.clear()


def dkg_plane_launches(msm_calls: dict, fold_calls: dict, key_calls: dict) -> int:
    """B2 launches the DKG plane's recorded MSMs, folds and channel-key
    batches imply."""
    from hydrabadger_tpu_torch.ops import msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt

    return (sum(k * msm_torch.launches(b, s) for (b, s, _w), k in msm_calls.items())
            + sum(k * vt.launches(J, xs) for (J, _K, xs), k in fold_calls.items())
            + sum(key_calls.values()))


def snapshot_classes(raw: bytes) -> set:
    """(module, name) of every class a sim checkpoint's pickle names, read
    by loading it once more through a recording find_class."""
    import io

    from hydrabadger_tpu_torch import checkpoint as ck

    names = set()

    class Recording(ck._PortUnpickler):
        def find_class(self, module, name):
            names.add((module, name))
            return super().find_class(module, name)

    Recording(io.BytesIO(ck._unpack(raw, ck._KIND_SIM))).load()
    return names


def era_switch_resume(dev: torch.device, tag: str, nodes: int) -> dict:
    """Phase 28a: config 5's era switch on the card with the DKG plane
    forced, uninterrupted and resumed from a mid-DKG snapshot (save_sim,
    the DKG caches cleared, load_sim), byte for byte."""
    import tempfile

    from hydrabadger_tpu_torch import checkpoint as ck
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto.engine import GpuEngine

    gpu = GpuEngine(device=dev)
    zero_launches(dev)
    straight, straight_m, straight_s = era_switch(gpu, nodes, tpu_dkg=True)
    by_straight, others = b2_launches(dev)
    check(sum(others.values()) == 0, f"the uninterrupted era switch launched other kernels: {others}")
    want = dhb_record(straight, straight_m)

    zero_launches(dev)
    sim, _t0 = voted_sim(gpu, nodes, tpu_dkg=True)
    done, live = 1, []
    for _ in range(8):
        sim.run(1)
        done += 1
        # (the removed node follows the switch with a tracker, no parts)
        live = [nid for nid in sim.ids if sim.nodes[nid].key_gen is not None
                and (getattr(sim.nodes[nid].key_gen.key_gen, "parts", None)
                     or sim.nodes[nid].pending_kg)]
        if live:
            break
    check(bool(live) and all(sim.nodes[nid].era == 0 for nid in sim.ids),
          "no epoch boundary with the era-switch DKG live and parts or acks pending")
    by_prefix, others_p = b2_launches(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "era_switch.ckpt")
        t0 = time.perf_counter()
        ck.save_sim(path, sim)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        del sim
        dkg.clear_caches()  # a fresh process starts with them cold
        t0 = time.perf_counter()
        resumed = ck.load_sim(path)
        load_ms = (time.perf_counter() - t0) * 1e3
        with open(path, "rb") as fh:
            classes = snapshot_classes(fh.read())
    modules = sorted({m for m, _n in classes})
    check(not any(m == "hydrabadger_tpu" or m.startswith("hydrabadger_tpu.") for m in modules),
          f"the snapshot names a module of the JAX package: {modules}")
    torch_names = sorted(f"{m}.{n}" for m, n in classes if m.split(".")[0] == "torch")
    check(torch_names == ["torch.device"], f"the snapshot holds torch state beyond devices: "
                                           f"{torch_names}")
    zero_launches(dev)
    t0 = time.perf_counter()
    m = resumed.run(straight_m.epochs_done - done)
    resumed_s = time.perf_counter() - t0
    by_resumed, others_r = b2_launches(dev)
    got = dhb_record(resumed, m)
    check(got == want, "the resumed era switch != the uninterrupted one (batches, eras, key sets, "
                       "validators, counts or faults differ)")
    check(all(e > 0 for e in got["eras"].values()), "the resumed run did not switch era")
    check(sum(others_p.values()) + sum(others_r.values()) == 0,
          f"the snapshotted run launched other kernels: {others_p}, {others_r}")
    check(sum(by_resumed.values()) > 0, "the resumed leg launched B2 no time")
    check(set(by_prefix) | set(by_resumed) == set(by_straight),
          f"the snapshotted run's B2 entries {sorted(set(by_prefix) | set(by_resumed))} != the "
          f"uninterrupted run's {sorted(by_straight)}")
    total = sum(by_prefix.values()) + sum(by_resumed.values())
    check(total >= sum(by_straight.values()),
          f"the snapshotted run launched B2 {total} times, fewer than the uninterrupted "
          f"{sum(by_straight.values())}")
    print(f"main path: config 5's era switch ({nodes} nodes) on the card, DKG plane forced, "
          f"snapshotted after epoch {done} with the DKG live on {len(live)} nodes (parts or acks "
          f"pending), caches cleared, resumed to epoch {m.epochs_done}: every node's batches, eras, "
          f"key sets, validators, counts and faults == the uninterrupted run's; the snapshot holds "
          f"no tensor (torch names {torch_names}) and names no JAX module "
          f"({len(classes)} classes from {len(modules)} modules)")
    print(f"snapshot {size} bytes, save_sim {save_ms:.1f} ms, load_sim {load_ms:.1f} ms; B2 launches "
          f"uninterrupted {sum(by_straight.values())} {by_straight}, before the snapshot "
          f"{sum(by_prefix.values())}, resumed leg {sum(by_resumed.values())} {by_resumed} "
          f"(cold caches: {total - sum(by_straight.values())} more in all); walls uninterrupted "
          f"{straight_s:.2f} s, resumed leg {resumed_s:.2f} s {tag}")
    return {
        "per": f"config 5's era switch ({nodes} nodes) resumed from a mid-DKG sim snapshot: "
               f"the resumed leg's B2 launches",
        "launches": sum(by_resumed.values()),
        "launches_by_entry": by_resumed,
        "launches_before_snapshot": sum(by_prefix.values()),
        "launches_uninterrupted": sum(by_straight.values()),
        "snapshot_epoch": done,
        "snapshot_bytes": size,
        "save_ms": save_ms,
        "load_ms": load_ms,
        "resumed_s": resumed_s,
        "uninterrupted_s": straight_s,
    }


def tcp_restart(dev: torch.device, tag: str, base: int = 15400, cap_s: float = 300.0) -> dict:
    """Phase 28b: config 1 on the card with checkpoints every epoch and a
    flight recorder on each node, stopped after 2 batches, every node
    restored from its store's newest generation (epochs aligned to the
    newest), restarted to 2 more batches."""
    import asyncio
    import dataclasses
    import tempfile

    from hydrabadger_tpu_torch.checkpoint import CheckpointStore
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto import engine as teng
    from hydrabadger_tpu_torch.net.node import Config, Hydrabadger
    from hydrabadger_tpu_torch.obs import metrics as M
    from hydrabadger_tpu_torch.obs.flight import FlightRecorder, load_flight
    from hydrabadger_tpu_torch.obs.recorder import DOMAIN_WALL, Recorder
    from hydrabadger_tpu_torch.ops import msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt
    from hydrabadger_tpu_torch.utils.ids import InAddr, OutAddr

    n = 4
    Rec = recording_gpu_engine(dev)
    gen = lambda count, size: [b"%02dx" % i * size for i in range(count)]  # noqa: E731

    def mount(node, rec, prefix):
        """A flight recorder on the node's recorder, metrics and fault ring."""
        node.flight = FlightRecorder(prefix, node=node.uid.bytes.hex()[:8], recorder=rec,
                                     metrics=node.metrics, fault_ring=node.fault_log,
                                     clock=node.wall_now, mono=node._now)

    async def drive(nodes, port0, batches):
        """Start every node dialling the others; wait until each has
        `batches` batches (or the cap); stop them.  Returns (wall s, s to
        the first batch on every node)."""
        for i, node in enumerate(nodes):
            await node.start([OutAddr("127.0.0.1", port0 + j) for j in range(n) if j != i], gen)
        t0 = time.perf_counter()
        first = None
        while min(len(node.batches) for node in nodes) < batches:
            if first is None and min(len(node.batches) for node in nodes) >= 1:
                first = time.perf_counter() - t0
            if time.perf_counter() - t0 > cap_s:
                break
            await asyncio.sleep(0.02)
        wall = time.perf_counter() - t0
        for node in nodes:
            await node.stop()
        return wall, wall if first is None else first

    reg = M.default_registry()
    os.environ[dkg.GPU_DKG_ENV] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def cfg(i):
                return Config(txn_gen_interval_ms=300, keygen_peer_count=n - 1,
                              engine="gpu-recording", checkpoint_path=os.path.join(tmp, f"node{i}.ckpt"),
                              checkpoint_every=1)

            dkg.clear_caches()
            teng._VERIFIED_FRAMES.clear()
            recs = [Recorder(clock_domain=DOMAIN_WALL) for _ in range(n)]
            first = [Hydrabadger(InAddr("127.0.0.1", base + i), cfg(i), seed=1000 + i,
                                 recorder=recs[i]) for i in range(n)]
            for i, node in enumerate(first):
                mount(node, recs[i], os.path.join(tmp, f"node{i}.run0.flight"))
            wall0, _ = asyncio.run(drive(first, base, 2))
            testnet_checks(first, 2, "config 1 with checkpoints on the card")
            stores = [CheckpointStore(cfg(i).checkpoint_path) for i in range(n)]
            cps = [store.load() for store in stores]
            for i, (node, cp) in enumerate(zip(first, cps)):
                check(cp is not None and cp == node.checkpoint(),
                      f"node {i}'s newest checkpoint generation != its state at stop")
                check(all(os.path.exists(p) for p in stores[i].generation_paths()),
                      f"node {i}'s store did not rotate a generation")
            persisted0 = sum(nd.metrics.counter(M.CHECKPOINTS_PERSISTED).value for nd in first)
            skipped0 = sum(nd.metrics.counter(M.CHECKPOINT_PERSISTS_SKIPPED).value for nd in first)
            top = max(cp.epoch for cp in cps)
            cps = [dataclasses.replace(cp, epoch=top) for cp in cps]
            recs = [Recorder(clock_domain=DOMAIN_WALL) for _ in range(n)]
            restored = [Hydrabadger.from_checkpoint(InAddr("127.0.0.1", base + 10 + i), cps[i],
                                                    cfg(i), seed=2000 + i, recorder=recs[i])
                        for i in range(n)]
            check(all(nd.is_validator() and nd.our_id == old.our_id
                      for nd, old in zip(restored, first)), "a restored node is not the validator it was")
            for i, node in enumerate(restored):
                mount(node, recs[i], os.path.join(tmp, f"node{i}.run1.flight"))
            zero_launches(dev)
            Rec.verifies.clear()
            Rec.muls.clear()
            teng._VERIFIED_FRAMES.clear()
            before = reg.counter(M.VERIFY_DEVICE_BATCHES).value
            wall1, to_first = asyncio.run(drive(restored, base + 10, 2))
            by_kind, others = b2_launches(dev)
            msm_calls, fold_calls = dict(msm_torch.calls), dict(vt.calls)
            key_calls = dict(dkg.channel_key_calls)
            verifies, muls = list(Rec.verifies), list(Rec.muls)
            counted = reg.counter(M.VERIFY_DEVICE_BATCHES).value - before
            testnet_checks(restored, 2, "config 1 restarted from its checkpoints")
            check(all(nd.batches[0].epoch >= top for nd in restored),
                  f"a restored node committed an epoch below {top}")
            check(len({nd.dhb.netinfo.pk_set.to_bytes() for nd in first + restored}) == 1,
                  "the restored nodes' key set != the one the bootstrap DKG formed")
            replay_on_the_host(verifies, muls)
            check(len(muls) == counted > 0, f"the restarted testnet sent {len(muls)} verify batches "
                                            f"to the card (counted {counted}); want the same, > 0")
            dkg_launches = dkg_plane_launches(msm_calls, fold_calls, key_calls)
            check(sum(others.values()) == 0, f"the restarted testnet launched other kernels: {others}")
            check(len(muls) + dkg_launches == sum(by_kind.values()),
                  f"B2 launches {sum(by_kind.values())} != verify batches {len(muls)} + the DKG "
                  f"plane's {dkg_launches}")
            for i, nd in enumerate(restored):
                cp = stores[i].load()
                check(cp is not None and cp.epoch >= top + 2,
                      f"node {i}'s store holds epoch {cp and cp.epoch} after the restart, want >= "
                      f"{top + 2}")
            persisted1 = sum(nd.metrics.counter(M.CHECKPOINTS_PERSISTED).value for nd in restored)
            dumps = []
            for nd in first + restored:
                payload = load_flight(nd.flight.path)
                check(payload["reason"] == "stop" and payload["events"],
                      f"{nd.flight.path}: reason {payload['reason']!r}, {len(payload['events'])} events")
                dumps.append(len(payload["events"]))
    finally:
        os.environ.pop(dkg.GPU_DKG_ENV, None)
    print(f"main path: config 1 on the card with checkpoints every epoch and flight recorders: 2 "
          f"batches in {wall0:.2f} s, {persisted0} checkpoints persisted ({skipped0} skipped); every "
          f"node restored from its store's newest generation at epoch {top}, restarted: first batch "
          f"on every node {to_first:.2f} s after the restart, 2 agreed, decrypted batches in "
          f"{wall1:.2f} s at epochs >= {top}, {persisted1} more checkpoints; {len(verifies)} "
          f"verify_batch calls on the card replayed on the host with equal verdicts, every r_i * "
          f"pk_i == native; B2 launches {by_kind}, no other kernel; {len(dumps)} flight dumps load "
          f"with reason 'stop' ({min(dumps)}-{max(dumps)} events) {tag}")
    return {
        "per": "config 1 restarted from its checkpoints, to 2 batches on every node",
        "launches": sum(by_kind.values()),
        "launches_by_entry": by_kind,
        "verify_batches": len(muls),
        "checkpoints_persisted": persisted0 + persisted1,
        "restart_to_first_commit_s": to_first,
        "restart_wall_s": wall1,
        "first_run_wall_s": wall0,
    }


def adversarial_plane(dev: torch.device, tag: str) -> tuple[dict, dict, dict, int]:
    """Phase 29: the adversarial plane on the card.  Returns the records for
    B1's entry (the attacked sims), for B2's (the attacked era switch and
    the chaos cluster) and the worst error of the sketch holds."""
    import asyncio

    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto import engine as teng
    from hydrabadger_tpu_torch.crypto import homhash
    from hydrabadger_tpu_torch.net import chaos
    from hydrabadger_tpu_torch.ops import gf256_torch, homhash_torch, msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt
    from hydrabadger_tpu_torch.sim import network
    from hydrabadger_tpu_torch.sim.byzantine import EquivocateRbc
    from hydrabadger_tpu_torch.sim.scenario import ScenarioSpec, attack_spec

    t_phase = time.perf_counter()
    gpu = teng.GpuEngine(device=dev)

    def leg(engine, spec, variant, nodes=ATTACK_NODES, timed=ATTACK_EPOCHS):
        """Config 11's leg (bench.py:1002-1025): qhb, encryption and share
        checks, seed 23, a warm epoch, then `timed` epochs; the contract
        verified on an attacked run.  Returns (sim, metrics, epochs/s)."""
        sim = network.SimNetwork(network.SimConfig(
            n_nodes=nodes, protocol="qhb", encrypt=True, verify_shares=True, seed=ATTACK_SEED,
            scenario=spec, rbc_variant=variant, engine=engine, native_acs=False))
        sim.run(1)
        warm = sim.total_wall_s
        m = sim.run(timed)
        check(m.agreement_ok and m.epochs_done == timed + 1,
              f"attack leg ({nodes} nodes, {variant}): agreement {m.agreement_ok}, "
              f"{m.epochs_done} epochs, want {timed + 1}")
        if spec is not None:
            sim.verify_scenario()  # every injected kind surfaced, or raise
        sim.shutdown()
        return sim, m, timed / (sim.total_wall_s - warm)

    def record(sim, m) -> dict:
        """What the two engines' runs must share: the honest nodes' batches,
        the counts, the faults, the injections and the byz_* counters."""
        return {"batches": {nid: sim.batch_bytes(nid) for nid in sim.honest_ids},
                "counts": (m.epochs_done, m.messages_delivered, m.txns_committed, m.faults),
                "faults": [(s, f.node_id, f.kind) for s, f in sim.router.faults],
                "injected": dict(sim.scenario_log.counts) if sim.scenario_log else {},
                "byz": {k: v for k, v in sim.metrics.snapshot()["counters"].items()
                        if k.startswith("byz_")}}

    def launched() -> tuple[int, dict]:
        """B1's launches, and every other kernel's (B2 summed over its
        entries), since the counters were set to 0."""
        by_kind, others = b2_launches(dev)
        return others.pop("gf256_matmul"), dict(others, fq_point=sum(by_kind.values()))

    # -- 29a. config 11 at 4 nodes, the reference broadcast -----------------
    spec = attack_spec(ATTACK_NODES, seed=ATTACK_SEED)
    zero_launches(dev)
    a_gpu, a_gpu_m, a_gpu_eps = leg(gpu, spec, "bracha")
    b1, rest = launched()
    check(b1 == 0 and sum(rest.values()) == 0,
          f"the attacked bracha sim launched kernels: B1 {b1}, others {rest}")
    a_cpu, a_cpu_m, a_cpu_eps = leg("cpu", spec, "bracha")
    h_gpu, h_gpu_m, h_gpu_eps = leg(gpu, None, "bracha")
    h_cpu, h_cpu_m, h_cpu_eps = leg("cpu", None, "bracha")
    check(record(a_gpu, a_gpu_m) == record(a_cpu, a_cpu_m),
          "the attacked bracha sim on the card != the host engine's run")
    check(record(h_gpu, h_gpu_m) == record(h_cpu, h_cpu_m),
          "the honest twin on the card != the host engine's run")
    ratios = {"gpu": a_gpu_eps / h_gpu_eps, "cpu": a_cpu_eps / h_cpu_eps}
    check(min(ratios.values()) >= 0.5, f"attacked/honest epochs/s below 0.5: {ratios}")
    injected = dict(a_gpu.scenario_log.counts)
    byz_faults = {k: v for k, v in record(a_gpu, a_gpu_m)["byz"].items()
                  if k.startswith("byz_faults_")}
    print(f"main path: config 11 ({ATTACK_NODES} nodes, f = 1, qhb, bracha, encryption and share "
          f"checks, seed {ATTACK_SEED}, 1 + {ATTACK_EPOCHS} epochs) attacked and honest, each on "
          f"GpuEngine and the host engine: honest batches, counts, faults and injections "
          f"byte-identical across the engines, the contract held, 0 kernel launches; injected "
          f"{injected}, observed {byz_faults}; epochs/s attacked gpu {a_gpu_eps:.3f} / cpu "
          f"{a_cpu_eps:.3f}, honest gpu {h_gpu_eps:.3f} / cpu {h_cpu_eps:.3f}, attacked/honest gpu "
          f"{ratios['gpu']:.3f} cpu {ratios['cpu']:.3f} {tag}")

    # -- 29b. the same leg with the low-comm broadcast: kernel B1 -----------
    def lowcomm_counted(engine, nodes, timed):
        homhash_torch.calls.clear()
        zero_launches(dev)
        sim, m, eps = leg(engine, attack_spec(nodes, seed=ATTACK_SEED), "lowcomm", nodes, timed)
        b1, rest = launched()
        calls = dict(homhash_torch.calls)
        implied = sum(n * len(gf256_torch.chunks(8, L)) for (_b, L), n in calls.items())
        check(b1 > 0 and b1 == implied,
              f"attacked lowcomm sim ({nodes} nodes): B1 launches {b1}, implied by the sketch "
              f"calls {implied}")
        check(sum(rest.values()) == 0, f"the attacked lowcomm sim launched other kernels: {rest}")
        forged = sum(len(s._alt_lc) for nid in sim.ids if nid not in sim.honest_ids
                     for s in sim.nodes[nid]._strategies if isinstance(s, EquivocateRbc))
        return sim, m, eps, b1, calls, forged

    lc_gpu, lc_gpu_m, lc_gpu_eps, lc_b1, lc_calls, lc_forged = lowcomm_counted(
        gpu, ATTACK_NODES, ATTACK_EPOCHS)
    lc_cpu, lc_cpu_m, lc_cpu_eps = leg("cpu", spec, "lowcomm")
    check(record(lc_gpu, lc_gpu_m) == record(lc_cpu, lc_cpu_m),
          "the attacked lowcomm sim on the card != the host engine's run")
    check(lc_forged > 0, "the equivocating node forged no second coding")
    worst = 0
    for (B, L), _n in sorted(lc_calls.items()):  # every call shape, exact
        op = gf256_torch.operand(homhash.matrix_T(b"attack", L), dev)
        rows = torch.randint(0, 256, (B, L), dtype=torch.uint8, device=dev)
        got = gf256_torch.gf_matmul(op, rows.T)
        want = gf256_torch.gf_matmul_bits_plain(op, rows.T)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, want))
        check(torch.equal(got, want),
              f"gf256_matmul != plain at the attacked run's sketch (8,{L}) x {B}")
    t16 = time.perf_counter()
    big, big_m, big_eps, big_b1, big_calls, big_forged = lowcomm_counted(
        gpu, ATTACK16_NODES, ATTACK16_EPOCHS - 1)
    big_s = time.perf_counter() - t16
    check(len(big.honest_ids) == ATTACK16_NODES - (ATTACK16_NODES - 1) // 3,
          f"16-node attack: {len(big.honest_ids)} honest nodes")
    print(f"config 11 with the low-comm broadcast, {ATTACK_NODES} nodes: honest batches, counts, "
          f"faults and injections byte-identical across the engines; B1 {lc_b1} launches == those "
          f"{sum(lc_calls.values())} sketch calls imply ({lc_forged} of them the equivocator's "
          f"forged codings), no other kernel, every call shape exact; epochs/s gpu "
          f"{lc_gpu_eps:.3f}, cpu {lc_cpu_eps:.3f}; {ATTACK16_NODES} nodes, f = "
          f"{(ATTACK16_NODES - 1) // 3}, "
          f"{ATTACK16_EPOCHS} epochs on GpuEngine: agreement, the contract held, B1 {big_b1} "
          f"launches == those {sum(big_calls.values())} sketch calls imply ({big_forged} forged), "
          f"{big_s:.1f} s, injected {dict(big.scenario_log.counts)} {tag}")

    # -- 29c. the dhb era switch under attack, the DKG plane forced ----------
    def era_leg(engine, flag):
        dkg.clear_caches()
        scen = ScenarioSpec(name="era", seed=ERA_ATTACK_SEED,
                            byzantine=((3, ("equivocate", "dkg_corrupt", "replay_flood")),))
        sim = network.SimNetwork(network.SimConfig(
            n_nodes=4, protocol="dhb", epochs=4, seed=ERA_ATTACK_SEED, engine=engine,
            tpu_dkg=flag, scenario=scen, native_acs=False))
        for nid in sim.honest_ids:
            sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(sim.ids[3]))
        t0 = time.perf_counter()
        m = sim.run()
        wall = time.perf_counter() - t0
        check(m.agreement_ok and m.epochs_done == 4, f"attacked era switch: {m.epochs_done} epochs")
        check(all(sim.nodes[nid].era > 0 for nid in sim.honest_ids),
              "the attacked era switch did not complete")
        sim.verify_scenario()
        sim.shutdown()
        rec = record(sim, m)
        rec["eras"] = {nid: sim.nodes[nid].era for nid in sim.honest_ids}
        rec["dhb"] = {nid: [(b.era, b.epoch, b.change) for b in sim.nodes[nid].batches]
                      for nid in sim.honest_ids}
        return rec, wall

    zero_launches(dev)
    e_gpu, e_gpu_s = era_leg(gpu, True)
    e_by_kind, e_others = b2_launches(dev)
    e_dkg = dkg_plane_launches(dict(msm_torch.calls), dict(vt.calls), dict(dkg.channel_key_calls))
    e_cpu, e_cpu_s = era_leg("cpu", False)
    check(e_gpu == e_cpu, "the attacked era switch on the card != the host engine's run")
    check(all(v > 0 for v in e_by_kind.values()) and sum(e_by_kind.values()) == e_dkg > 0,
          f"attacked era switch: B2 launches {e_by_kind} != the DKG plane's {e_dkg}")
    check(sum(e_others.values()) == 0, f"the attacked era switch launched other kernels: {e_others}")
    print(f"the dhb era switch under attack (4 nodes, seed {ERA_ATTACK_SEED}, the equivocating, "
          f"keygen-corrupting, replay-flooding node voted out), the DKG plane forced: honest "
          f"batches, eras, faults and injections byte-identical across the engines, the contract "
          f"held; B2 launches by entry {e_by_kind} == the DKG plane's {e_dkg}, no other kernel; "
          f"wall gpu {e_gpu_s:.2f} s, cpu {e_cpu_s:.2f} s; injected {e_gpu['injected']} {tag}")

    # -- 29d. config 12: the chaos cluster on the card -----------------------
    Rec = recording_gpu_engine(dev)
    Rec.verifies.clear()
    Rec.muls.clear()
    teng._VERIFIED_FRAMES.clear()
    dkg.clear_caches()
    zero_launches(dev)
    os.environ[dkg.GPU_DKG_ENV] = "1"
    t0 = time.perf_counter()
    try:
        row = asyncio.run(chaos.chaos_cluster(
            n=4, f_byz=1, epochs=CHAOS_EPOCHS, base_port=15450, crash=True, trace=True,
            deadline_s=CHAOS_DEADLINE_S, engine="gpu-recording"))
    finally:
        os.environ.pop(dkg.GPU_DKG_ENV, None)
    chaos_s = time.perf_counter() - t0
    c_by_kind, c_others = b2_launches(dev)
    c_dkg = dkg_plane_launches(dict(msm_torch.calls), dict(vt.calls), dict(dkg.channel_key_calls))
    verifies, muls = list(Rec.verifies), list(Rec.muls)
    check(row["agreement_ok"] and row["contract_ok"] and row["epochs"] >= CHAOS_EPOCHS,
          f"chaos cluster: {row}")
    check(row["recovery_catchup_s"] is not None, "the crashed node never caught up")
    check(row["byz_injected"].get("sig_corrupt", 0) > 0 and row["detections"]["wire_sig_rejected"] > 0,
          "no signature corruption injected or detected")
    replay_on_the_host(verifies, muls, all_pass=False)
    check(len(muls) > 0 and len(muls) + c_dkg == sum(c_by_kind.values()),
          f"chaos cluster: B2 launches {c_by_kind} != verify batches {len(muls)} + the DKG "
          f"plane's {c_dkg}")
    check(sum(c_others.values()) == 0, f"the chaos cluster launched other kernels: {c_others}")
    rejected = sum(not v for _i, vs in verifies for v in vs)
    keys = ("commit_gap_max_s", "recovery_catchup_s", "epochs_per_sec", "wall_s", "epochs",
            "crash_at_epoch", "epoch_critical_stage", "straggler_node", "msg_latency_p50_s",
            "msg_latency_p99_s", "commit_spread_max_s", "epochs_attributed", "bytes_per_epoch")
    print(f"main path: config 12's chaos cluster on the card (4 nodes, f = 1, full crypto, signed "
          f"frames, the default wire spec, a crash {row['crash_down_s']} s down and a restart from "
          f"a stale checkpoint, traced, {CHAOS_EPOCHS} epochs): liveness, agreement, byte-identical "
          f"recovery and the wire contract held; {len(verifies)} verify_batch calls on the card "
          f"({rejected} frames rejected) replayed on the host with equal verdicts, every r_i * pk_i "
          f"== native; B2 launches by entry {c_by_kind} == {len(muls)} verify batches + the DKG "
          f"plane's {c_dkg}, no other kernel; {json.dumps({k: row[k] for k in keys})}; injected "
          f"{row['byz_injected']}, detections {row['detections']}; {chaos_s:.1f} s {tag}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 29: {phase_s:.1f} s {tag}")
    b1_rec = {
        "per": f"config 11 attacked, {ATTACK_NODES} nodes x 1 + {ATTACK_EPOCHS} epochs, lowcomm",
        "launches": lc_b1, "sketch_calls": sum(lc_calls.values()), "forged_codings": lc_forged,
        "gpu_epochs_per_s": lc_gpu_eps, "cpu_epochs_per_s": lc_cpu_eps,
        "bracha": {"launches": 0, "attacked_gpu_epochs_per_s": a_gpu_eps,
                   "attacked_cpu_epochs_per_s": a_cpu_eps, "honest_gpu_epochs_per_s": h_gpu_eps,
                   "honest_cpu_epochs_per_s": h_cpu_eps, "attacked_over_honest": ratios,
                   "injected": injected, "byz_faults": byz_faults},
        "lowcomm_16": {"launches": big_b1, "sketch_calls": sum(big_calls.values()),
                       "forged_codings": big_forged, "wall_s": big_s, "epochs_per_s": big_eps},
    }
    era_rec = {"per": f"the 4-node dhb era switch under attack, seed {ERA_ATTACK_SEED}",
               "launches": sum(e_by_kind.values()), "launches_by_entry": e_by_kind,
               "gpu_wall_s": e_gpu_s, "cpu_wall_s": e_cpu_s}
    chaos_rec = {"per": f"config 12's chaos cluster, {CHAOS_EPOCHS} epochs under fault",
                 "launches": sum(c_by_kind.values()), "launches_by_entry": c_by_kind,
                 "verify_batches": len(muls), "frames_rejected": rejected, "wall_s": chaos_s,
                 **{k: row[k] for k in keys}, "phase_s": phase_s}
    return b1_rec, era_rec, chaos_rec, worst


def process_cluster(dev: torch.device, tag: str) -> dict:
    """Phase 30a: config 13 (bench.py:1228-1281) on the card: four port node
    processes on GpuEngine, node 1 SIGKILLed and restarted from its store.
    Returns the record for B2's entry (launches read from the children's
    feeds)."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.net import cluster

    zero_launches(dev)
    os.environ[dkg.GPU_DKG_ENV] = "1"  # the children inherit it: bootstrap DKG on B2
    t0 = time.perf_counter()
    try:
        row = cluster.run_process_chaos(
            n=4, epochs=PROC_EPOCHS, base_port=PROC_BASE_PORT, fast_crypto=False,
            deadline_s=PROC_DEADLINE_S, engine="gpu", device="cuda")
    finally:
        os.environ.pop(dkg.GPU_DKG_ENV, None)
    wall_s = time.perf_counter() - t0
    by_kind, others = b2_launches(dev)
    check(sum(by_kind.values()) == 0 and sum(others.values()) == 0,
          f"the supervisor itself launched kernels: B2 {by_kind}, others {others}")
    check(row["agreement_ok"] and row["contract_ok"] and row["epochs"] >= PROC_EPOCHS,
          f"config 13: agreement {row['agreement_ok']}, contract {row['contract_ok']}, "
          f"{row['epochs']} epochs")
    check(row["recovery_catchup_s"] is not None, "config 13: the killed node never caught up")
    check(row["flight_dumps_found"] > 0, "config 13: no flight dump found")
    killed = set(row["killed_pids"]["1"])
    work = row["device_work"]
    for node, incarnations in sorted(work.items()):
        batches = sum(inc["verify_batches"] for inc in incarnations)
        launches = sum(inc["launches"].get("fq_point", 0) for inc in incarnations)
        check(batches > 0 and launches >= batches,
              f"config 13 node {node}: {batches} verify batches, {launches} B2 launches")
        check(all(inc["launches"].get("gf256_matmul", 0) == 0 for inc in incarnations),
              f"config 13 node {node} launched B1: {incarnations}")
    restarted = [inc for inc in work["1"] if inc["pid"] not in killed]
    dead = [inc for inc in work["1"] if inc["pid"] in killed]
    check(len(dead) == 1 and len(restarted) == 1,
          f"config 13 node 1: incarnations {work['1']}, killed pids {sorted(killed)}")
    check(restarted[0]["verify_batches"] > 0 and restarted[0]["launches"]["fq_point"] > 0,
          f"config 13: the restarted incarnation made no B2 verify batch: {restarted[0]}")
    launches = sum(inc["launches"]["fq_point"] for incs in work.values() for inc in incs)
    batches = sum(inc["verify_batches"] for incs in work.values() for inc in incs)
    lanes = sum(inc["verify_lanes"] for incs in work.values() for inc in incs)
    per_node = {node: [(inc["verify_batches"], inc["verify_lanes"], inc["launches"]["fq_point"])
                       for inc in incs] for node, incs in sorted(work.items())}
    print(f"main path: config 13, four `python -m hydrabadger_tpu_torch --engine gpu` processes "
          f"(full crypto, the DKG plane forced), node 1 SIGKILLed at +2 s and restarted from its "
          f"store 3 s later, node 2 skewed +30 s at rate 1.25, {PROC_EPOCHS} epochs under fault: "
          f"agreement, the process-tier contract, exit 0 on SIGTERM with a final checkpoint, the "
          f"killed incarnation's flight dump; commit gap {row['commit_gap_max_s']} s, catch-up "
          f"{row['recovery_catchup_s']} s, {row['epochs_per_sec']} epochs/s under fault, wall "
          f"{row['wall_s']} s ({wall_s:.1f} s with start-up and checks); (verify batches, lanes, "
          f"B2 launches) per node and incarnation {per_node} (node 1: killed, then restarted); "
          f"gating stage {row['epoch_critical_stage']}, straggler {row['straggler_node']}, msg "
          f"latency p99 {row['msg_latency_p99_s']} s; detections {row['detections']}; injected "
          f"{row['byz_injected']} {tag}")
    keys = ("commit_gap_max_s", "recovery_catchup_s", "epochs_per_sec", "wall_s", "epochs",
            "epoch_critical_stage", "straggler_node", "msg_latency_p50_s", "msg_latency_p99_s",
            "flight_dumps_found", "supervisor_rss_growth_mb")
    return {"per": f"config 13: 4 node processes, {PROC_EPOCHS} epochs under a SIGKILL",
            "launches": launches, "verify_batches": batches, "verify_lanes": lanes,
            "per_node_incarnation": per_node, "phase_wall_s": wall_s,
            **{k: row[k] for k in keys}}


def soak_tiers(dev: torch.device, tag: str) -> tuple[dict, dict, dict]:
    """Phase 30b: the soak's era, low-comm and TCP tiers on the card, cut
    (PERF.md section 4), and the sim tier on the native ACS core.  Returns the
    records for B1's entry (rbc) and for B2's (era, tcp)."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto import engine as teng
    from hydrabadger_tpu_torch.ops import gf256_torch, homhash_torch, msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt
    from hydrabadger_tpu_torch.sim import soak

    gpu = {"engine": "gpu", "device": "cuda"}
    # -- the era tier: 16 nodes, 2 removal switches, the DKG plane forced ----
    dkg.clear_caches()
    zero_launches(dev)
    os.environ[dkg.GPU_DKG_ENV] = "1"
    t0 = time.perf_counter()
    try:
        era = soak.era_soak(n_nodes=SOAK_ERA_NODES, steady_epochs=SOAK_ERA_STEADY,
                            eras=SOAK_ERAS, **gpu)
    finally:
        os.environ.pop(dkg.GPU_DKG_ENV, None)
    era_s = time.perf_counter() - t0
    e_by_kind, e_others = b2_launches(dev)
    e_dkg = dkg_plane_launches(dict(msm_torch.calls), dict(vt.calls), dict(dkg.channel_key_calls))
    check(era["census_flat"] and era["agreement_ok"] and len(era["era_switch_epochs"]) == SOAK_ERAS,
          f"era soak: {era}")
    check(sum(e_by_kind.values()) == e_dkg > 0,
          f"era soak: B2 launches {e_by_kind} != the DKG plane's {e_dkg}")
    check(sum(e_others.values()) == 0, f"era soak launched other kernels: {e_others}")
    print(f"soak era tier ({SOAK_ERA_NODES} nodes, {SOAK_ERAS} removal switches, "
          f"{SOAK_ERA_STEADY} steady epochs an era, the DKG plane forced) on GpuEngine: census "
          f"flat, agreement, every switch done (epochs to switch {era['era_switch_epochs']}); B2 "
          f"launches by entry {e_by_kind} == the DKG plane's {e_dkg}, no other kernel; era commit "
          f"gap {era['era_commit_gap_s']} s (bound {era['era_gap_bound_s']}), steady p50 by era "
          f"{era['era_steady_p50_s']} s, {era['epochs_per_sec']} epochs/s, {era_s:.1f} s; census "
          f"final {era['census_final']} {tag}")
    # -- the low-comm tier: 16 nodes, bracha vs lowcomm, the twin on B1 ------
    homhash_torch.calls.clear()
    zero_launches(dev)
    t0 = time.perf_counter()
    rbc = soak.rbc_soak(epochs=SOAK_RBC_EPOCHS, n_nodes=SOAK_RBC_NODES, **gpu)
    rbc_s = time.perf_counter() - t0
    r_by_kind, r_others = b2_launches(dev)
    b1 = r_others.pop("gf256_matmul")
    calls = dict(homhash_torch.calls)
    implied = sum(n * len(gf256_torch.chunks(8, L)) for (_b, L), n in calls.items())
    check(b1 > 0 and b1 == implied,
          f"rbc soak: B1 launches {b1}, implied by the {sum(calls.values())} sketch calls {implied}")
    check(sum(r_by_kind.values()) == 0 and sum(r_others.values()) == 0,
          f"rbc soak launched other kernels: B2 {r_by_kind}, {r_others}")
    check(rbc["homhash_lane_occupancy"] == 1.0, f"rbc soak occupancy {rbc['homhash_lane_occupancy']}")
    print(f"soak low-comm tier ({SOAK_RBC_NODES} nodes x {SOAK_RBC_EPOCHS} epochs a leg) on "
          f"GpuEngine: batches identical across bracha and lowcomm, the device twin byte-equal to "
          f"the host sketches, occupancy 1.0; B1 {b1} launches == those {sum(calls.values())} "
          f"sketch calls imply, no other kernel; bytes/epoch bracha {rbc['bytes_per_epoch_bracha']}"
          f" lowcomm {rbc['bytes_per_epoch_lowcomm']} ({rbc['bytes_reduction']} cut), epochs/s "
          f"{rbc['epochs_per_sec_bracha']} / {rbc['epochs_per_sec_lowcomm']}, {rbc_s:.1f} s {tag}")
    # -- the TCP tier: 4 localhost nodes at full crypto, cut -----------------
    zero_launches(dev)
    t0 = time.perf_counter()
    tcp = soak.tcp_soak(epochs=SOAK_TCP_EPOCHS, base_port=SOAK_TCP_PORT, **gpu)
    tcp_s = time.perf_counter() - t0
    t_by_kind, t_others = b2_launches(dev)
    t_batches = sum(teng.device_verify_calls.values())
    t_dkg = dkg_plane_launches(dict(msm_torch.calls), dict(vt.calls), dict(dkg.channel_key_calls))
    check(tcp["epochs"] >= SOAK_TCP_EPOCHS, f"tcp soak: {tcp['epochs']} epochs")
    check(t_batches > 0 and sum(t_by_kind.values()) == t_batches + t_dkg,
          f"tcp soak: B2 launches {t_by_kind} != {t_batches} verify batches + the DKG plane's "
          f"{t_dkg}")
    check(sum(t_others.values()) == 0, f"tcp soak launched other kernels: {t_others}")
    print(f"soak TCP tier (4 localhost nodes, full crypto, {SOAK_TCP_EPOCHS} epochs) on GpuEngine: "
          f"queue and RSS bounds held (peaks {tcp['queue_peaks']}, RSS +{tcp['rss_growth_mb']} MB); "
          f"B2 launches {sum(t_by_kind.values())} == {t_batches} verify batches + the DKG plane's "
          f"{t_dkg}, no other kernel; {tcp['epochs_per_sec']} epochs/s, {tcp_s:.1f} s {tag}")
    # -- the sim tier: the native ACS core, no device call -------------------
    zero_launches(dev)
    t0 = time.perf_counter()
    sim = soak.sim_soak(epochs=SOAK_SIM_EPOCHS, n_nodes=SOAK_SIM_NODES, **gpu)
    sim_s = time.perf_counter() - t0
    s_by_kind, s_others = b2_launches(dev)
    check(sim["agreement_ok"] and sim["epochs"] >= SOAK_SIM_EPOCHS, f"sim soak: {sim['epochs']}")
    check(sum(s_by_kind.values()) == 0 and sum(s_others.values()) == 0,
          f"the sim soak (bracha, hash coin) launched kernels: {s_by_kind}, {s_others}")
    print(f"soak sim tier ({sim['tier']}, {SOAK_SIM_NODES} nodes x {sim['epochs']} epochs) on "
          f"GpuEngine: agreement, RSS +{sim['rss_growth_mb']} MB, throughput stable, 0 launches; "
          f"{sim['epochs_per_sec']} epochs/s, {sim_s:.1f} s {tag}")
    b1_rec = {"per": f"soak low-comm tier, {SOAK_RBC_NODES} nodes x {SOAK_RBC_EPOCHS} epochs",
              "launches": b1, "sketch_calls": sum(calls.values()), "wall_s": rbc_s,
              "bytes_reduction": rbc["bytes_reduction"]}
    era_rec = {"per": f"soak era tier, {SOAK_ERA_NODES} nodes x {SOAK_ERAS} switches",
               "launches": sum(e_by_kind.values()), "launches_by_entry": e_by_kind,
               "era_commit_gap_s": era["era_commit_gap_s"],
               "era_steady_p50_s": era["era_steady_p50_s"], "wall_s": era_s}
    tcp_rec = {"per": f"soak TCP tier, 4 nodes x {SOAK_TCP_EPOCHS} epochs",
               "launches": sum(t_by_kind.values()), "verify_batches": t_batches,
               "epochs_per_sec": tcp["epochs_per_sec"], "wall_s": tcp_s,
               "sim_tier_epochs_per_sec": sim["epochs_per_sec"]}
    return b1_rec, era_rec, tcp_rec


class DkgPlaneRecord:
    """Records the DKG plane's device results while installed: every MSM
    batch (its jobs and sums), commitment fold (its matrix, points and
    folds) and channel-key batch (points, scalars, products), the MSM
    digits for the bound, and CUDA events around each kernel B2 launch.
    `install()` wraps the ops-level entry points the DKG calls;
    `uninstall()` restores them."""

    def __init__(self):
        self.msms, self.folds, self.keys, self.msm_digits, self.events = [], [], [], [], []
        self._saved = []

    def install(self) -> "DkgPlaneRecord":
        from hydrabadger_tpu_torch.ops import bls_torch, fq_torch, msm_torch
        from hydrabadger_tpu_torch.ops import vandermonde_torch as vt

        rec = self
        msm_submit, msm_call = msm_torch.g1_msm_batch_submit, msm_torch.msm
        fold, key_batch, launch = vt.fold_points_batch, bls_torch.g1_scalar_mul_batch, fq_torch._launch

        def g1_msm_batch_submit(jobs, device="cuda", use_kernel=True):
            finish = msm_submit(jobs, device, use_kernel)

            def finished():
                sums = finish()
                rec.msms.append(([(list(p), list(k)) for p, k in jobs], sums))
                return sums
            return finished

        def msm(points, digits, b, s, use_kernel=True):
            rec.msm_digits.append((digits.cpu().numpy(), b, s))
            return msm_call(points, digits, b, s, use_kernel)

        def fold_points_batch(C, xs, use_kernel=True):
            out = fold(C, xs, use_kernel)
            rec.folds.append((C.cpu().numpy(), list(xs), out.cpu().numpy()))
            return out

        def g1_scalar_mul_batch(points, scalars, device="cuda", use_kernel=True):
            out = key_batch(points, scalars, device, use_kernel)
            rec.keys.append((list(points), list(scalars), out))
            return out

        def timed_launch(*a, **kw):
            before = fq_torch.launches
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*a, **kw)
            end.record()
            if fq_torch.launches != before:
                rec.events.append((start, end))
            return out

        for mod, name, fn in ((msm_torch, "g1_msm_batch_submit", g1_msm_batch_submit),
                              (msm_torch, "msm", msm), (vt, "fold_points_batch", fold_points_batch),
                              (bls_torch, "g1_scalar_mul_batch", g1_scalar_mul_batch),
                              (fq_torch, "_launch", timed_launch)):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def uninstall(self) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()

    def device_ms(self) -> float:
        """Kernel B2's device ms: the sum of its launches' event pairs."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def bound(self) -> tuple[float, str]:
        """The least time for the recorded B2 work: each MSM's plan from its
        digits, each fold's, each channel-key batch's GLV plan."""
        from hydrabadger_tpu_torch.ops import bls_torch

        rows = []
        for d, b, s in self.msm_digits:
            rows += msm_plan(d, b, s)
        for C, xs, _out in self.folds:
            rows += fold_plan(C.shape[2], C.shape[3], xs)
        for pts, ks, _out in self.keys:
            _p, digits = bls_torch.scalar_mul_operands(pts, ks, "cpu")
            rows += bls_torch.glv_plan(digits.numpy())
        return roofline.bound_ms(*plan_bound(rows))

    def replay_on_the_host(self) -> dict:
        """Every recorded result against the host's native routes: each MSM
        sum against native `g1_msm`, each fold against the native Horner
        fold (`g1_fold_pow`) of the same matrix, each channel-key product
        against native `g1_mul_batch`; the native calls spread over the
        host's cores (ctypes releases the interpreter lock).  Returns the
        counts replayed."""
        from concurrent.futures import ThreadPoolExecutor

        from hydrabadger_tpu_torch.crypto import bls12_381 as bls
        from hydrabadger_tpu_torch.crypto import native_bls as nb
        from hydrabadger_tpu_torch.ops import limbs

        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            for batch, sums in self.msms:
                check(len(batch) == len(sums), "an MSM batch returned a sum per job")
            jobs = [job for batch, _sums in self.msms for job in batch]
            got = [p for _batch, sums in self.msms for p in sums]
            want = pool.map(lambda job: nb.g1_msm(*job), jobs)
            check(all(bls.eq(a, b) for a, b in zip(got, want)), "an MSM on the card != native g1_msm")
            folds = []
            for C, xs, out in self.folds:
                J, K = C.shape[2], C.shape[3]
                raw = b"".join(nb._g1_to_raw(p) for p in limbs.limbs_to_points(C))
                pts = limbs.limbs_to_points(out)
                shape = [[None] * K for _ in range(J)]
                folds += [(shape, x, raw, pts[mi * K:(mi + 1) * K]) for mi, x in enumerate(xs)]
            want = pool.map(lambda f: nb.g1_fold_pow(f[0], f[1], 0, raw96=f[2]), folds)
            check(all(len(w) == len(f[3]) and all(bls.eq(a, b) for a, b in zip(f[3], w))
                      for f, w in zip(folds, want)), "a fold on the card != native g1_fold_pow")
            want = pool.map(lambda k: nb.g1_mul_batch(k[0], k[1]), self.keys)
            check(all(len(w) == len(k[2]) and all(bls.eq(a, b) for a, b in zip(k[2], w))
                      for k, w in zip(self.keys, want)),
                  "a channel-key batch on the card != native g1_mul_batch")
        return {"msm_jobs": len(jobs), "msm_batches": len(self.msms), "fold_points": len(folds),
                "fold_calls": len(self.folds), "channel_keys": sum(len(k[0]) for k in self.keys),
                "channel_key_batches": len(self.keys)}


def msm_plan(d: np.ndarray, b: int, s: int) -> list:
    """The B2 launches of one MSM batch (ops/msm_torch) from its digits: the
    GLV ladder and its tree for 33 digit rows, else the windowed sum."""
    from hydrabadger_tpu_torch.ops import bls_torch

    if d.shape[-2] == 33:
        return bls_torch.glv_plan(d) + [row for row in bls_torch.weighted_sum_plan(
            np.zeros((1, b * s), np.int32), s) if row.part == "tree"]
    return bls_torch.weighted_sum_plan(d, s)


def c5_era_switch(engine, nodes: int, **kw) -> tuple:
    """Config 5 as bench.py runs it (bench.py:554-600) on the native ACS
    core: a bootstrap epoch, a removal vote for the last node from every
    other, epochs until every survivor is in era 1 (at most C5_ERA_EPOCHS),
    then C5_STEADY steady epochs, each timed on the host clock.  Returns
    (sim, metrics, walls)."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.sim import network

    dkg.clear_caches()
    sim = network.SimNetwork(network.SimConfig(
        n_nodes=nodes, protocol="dhb", txns_per_node_per_epoch=C5_TXNS, txn_bytes=2, seed=C5_SEED,
        native_acs=True, engine=engine, **kw))
    check(sim._native_eligible(), "config 5 is not eligible for the native ACS core")
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    sim.run(1)
    walls = {"bootstrap_s": time.perf_counter() - t0, "era_epoch_s": []}
    victim = sim.ids[-1]
    survivors = sim.ids[:-1]
    for nid in survivors:
        sim.router.dispatch_step(nid, sim.nodes[nid].vote_to_remove(victim))
    for _ in range(C5_ERA_EPOCHS):
        t0 = time.perf_counter()
        sim.run(1)
        walls["era_epoch_s"].append(time.perf_counter() - t0)
        if all(sim.nodes[nid].era > 0 for nid in survivors):
            break
    check(all(sim.nodes[nid].era > 0 for nid in survivors),
          f"config 5: the era switch did not complete in {C5_ERA_EPOCHS} epochs")
    check(all(victim not in sim.nodes[nid].netinfo.node_ids for nid in survivors),
          "config 5: the removed node is still in a survivor's validator set")
    t0 = time.perf_counter()
    m = sim.run(C5_STEADY)
    walls["steady_s"] = time.perf_counter() - t0
    walls["switch_s"] = sum(walls["era_epoch_s"])
    walls["total_s"] = time.perf_counter() - t_all
    check(m.agreement_ok, "config 5: agreement failed")
    return sim, m, walls


def faults_by_kind(sim) -> dict:
    out: dict = {}
    for _s, f in sim.router.faults:
        out[f.kind] = out.get(f.kind, 0) + 1
    return out


def native_cores(dev: torch.device, tag: str) -> dict:
    """Phase 31: the native host cores on the card.  31a, config 5's 64-node
    era switch on the native ACS core with the DKG plane forced on kernel
    B2, every recorded device result replayed on the host; 31b, the same
    leg at 16 nodes on GpuEngine and the host engine in turns, byte for
    byte; 31c, config 2's native tier on both engines in turns.  Returns the
    64-node record for B2's entry of the `kernels` line."""
    from hydrabadger_tpu_torch.crypto import dkg
    from hydrabadger_tpu_torch.crypto.engine import GpuEngine
    from hydrabadger_tpu_torch.obs import metrics as M
    from hydrabadger_tpu_torch.ops import msm_torch
    from hydrabadger_tpu_torch.ops import vandermonde_torch as vt
    from hydrabadger_tpu_torch.sim import network
    from hydrabadger_tpu_torch.utils import host_native

    gpu = GpuEngine(device=dev)
    builds = {lib.label: lib.build_seconds for lib in host_native.LIBRARIES}
    # -- 31a. config 5 at 64 nodes on the card -------------------------------
    reg = M.default_registry()
    flushes0 = reg.counter(M.MSM_COALESCE_FLUSHES).value
    rec = DkgPlaneRecord()
    zero_launches(dev)
    rec.install()
    try:
        sim, m, walls = c5_era_switch(gpu, C5_NODES, tpu_dkg=True)
    finally:
        rec.uninstall()
    by_kind, others = b2_launches(dev)
    msm_calls, fold_calls, key_calls = dict(msm_torch.calls), dict(vt.calls), dict(dkg.channel_key_calls)
    dev_ms = rec.device_ms()
    width = reg.gauge(M.MSM_COALESCE_WIDTH).high_water
    flushes = reg.counter(M.MSM_COALESCE_FLUSHES).value - flushes0
    check(sum(others.values()) == 0, f"config 5 launched B1, B3 or B4: {others}")
    for entry in ("windowed_ladder", "glv_ladder", "add", "dbl", "ladd"):
        check(by_kind.get(entry, 0) > 0, f"config 5 launched B2's {entry} no time: {by_kind}")
    implied = dkg_plane_launches(msm_calls, fold_calls, key_calls)
    check(sum(by_kind.values()) == implied == len(rec.events),
          f"config 5: B2 launches {by_kind} != the DKG plane's {implied} (events {len(rec.events)})")
    faults = faults_by_kind(sim)
    eras = sorted({sim.nodes[nid].era for nid in sim.ids[:-1]})
    print(f"main path: config 5 at {C5_NODES} nodes (seed {C5_SEED}, {C5_TXNS} x 2-byte txns a "
          f"node, the native ACS core, the DKG plane forced) on GpuEngine: agreement, survivors' "
          f"eras {eras}, {sim.ids[-1]} gone from every survivor's validators; "
          f"{m.messages_delivered} messages, faults by kind {faults}; B2 launches by entry "
          f"{by_kind} == the DKG plane's {implied}, no other kernel; coalescer {flushes} flushes, "
          f"widest {width}; MSM batches {sum(msm_calls.values())} over {len(msm_calls)} shapes, "
          f"folds {sum(fold_calls.values())} over {len(fold_calls)} shapes, channel-key batches "
          f"{sum(key_calls.values())}")
    t0 = time.perf_counter()
    replayed = rec.replay_on_the_host()
    replay_s = time.perf_counter() - t0
    bound, bound_by = rec.bound()
    busy = dev_ms / 1e3 / walls["total_s"]
    gap = sim.era_gap_snapshot()["era_commit_gap_s"]
    steady_eps = C5_STEADY / walls["steady_s"]
    print(f"config 5's DKG plane on the card == the host's native routes: {replayed} "
          f"({replay_s:.1f} s to replay)")
    print(f"config 5 at {C5_NODES} nodes: bootstrap {walls['bootstrap_s']:.3f} s, era epochs "
          f"{[round(w, 3) for w in walls['era_epoch_s']]} s (the switch {walls['switch_s']:.2f} s), "
          f"{C5_STEADY} steady epochs {steady_eps:.3f} epochs/s, era_commit_gap_s {gap}, whole "
          f"run {walls['total_s']:.2f} s; B2 {dev_ms:.2f} device ms by events over "
          f"{len(rec.events)} launches (the card busy {100 * busy:.3f}% of the run), bound "
          f"{bound:.5f} ms ({bound_by}); host builds {builds} {tag}")
    record = {
        "per": f"config 5's era switch at {C5_NODES} nodes on the native ACS core (bench.py:491-652): "
               f"a bootstrap epoch, the removal, {len(walls['era_epoch_s'])} era epochs, "
               f"{C5_STEADY} steady; every B2 launch timed by its own CUDA events",
        "launches": sum(by_kind.values()), "launches_by_entry": by_kind, "ms": dev_ms,
        "bound_ms": bound, "bound_by": bound_by, "busy_share": busy,
        "bootstrap_s": walls["bootstrap_s"], "era_epoch_s": walls["era_epoch_s"],
        "switch_s": walls["switch_s"], "steady_epochs_per_sec": steady_eps,
        "era_commit_gap_s": gap, "total_s": walls["total_s"], "faults_by_kind": faults,
        "messages_delivered": m.messages_delivered, "coalesce_flushes": flushes,
        "coalesce_width": width, "replayed": replayed, "replay_s": replay_s,
        "host_build_s": builds,
    }
    del sim, rec

    # -- 31b. the native core against the host engine, in turns -------------
    runs = []
    for spec, flag in (("cpu", False), (gpu, True), (gpu, True), ("cpu", False)):
        zero_launches(dev)
        t0 = time.perf_counter()
        leg, leg_m, _s = era_switch(spec, DKG_NODES, tpu_dkg=flag, native_acs=True)
        wall = time.perf_counter() - t0
        kinds, rest = b2_launches(dev)
        calls = dkg_plane_launches(dict(msm_torch.calls), dict(vt.calls),
                                   dict(dkg.channel_key_calls))
        check(sum(rest.values()) == 0, f"31b launched B1, B3 or B4: {rest}")
        if flag:
            check(sum(kinds.values()) == calls > 0, f"31b: B2 launches {kinds} != the DKG plane's {calls}")
        else:
            check(sum(kinds.values()) == 0, f"31b: the host engine launched B2: {kinds}")
        runs.append(("gpu" if flag else "cpu", dhb_record(leg, leg_m), wall, kinds,
                     faults_by_kind(leg)))
    want = runs[0][1]
    check(all(r[1] == want for r in runs),
          "31b: the native-core era switch on the card != the host engine's (batches, eras, key "
          "sets, validators, counts or faults)")
    print(f"31b: config 5's leg at {DKG_NODES} nodes on the native ACS core, in turns (cpu, gpu, "
          f"gpu, cpu): byte-identical batches, eras, key sets, {want['counts'][1]} messages, faults "
          f"by kind {runs[0][4]}; walls {[(r[0], round(r[2], 3)) for r in runs]} s; B2 launches "
          f"{[sum(r[3].values()) for r in runs]} {tag}")

    # -- 31c. config 2's native tier, in turns --------------------------------
    c2 = []
    for spec in ("cpu", gpu, gpu, "cpu"):
        zero_launches(dev)
        net = network.SimNetwork(network.SimConfig(n_nodes=C2_NODES, protocol="qhb", seed=0,
                                                   engine=spec))
        check(net._native_eligible(), "config 2 is not eligible for the native ACS core")
        c2m = net.run(C2_EPOCHS)
        kinds, rest = b2_launches(dev)
        check(c2m.agreement_ok and c2m.epochs_done == C2_EPOCHS, f"config 2 native: {c2m.as_dict()}")
        check(sum(kinds.values()) + sum(rest.values()) == 0,
              f"config 2's native tier launched kernels: {kinds}, {rest}")
        c2.append(("cpu" if spec == "cpu" else "gpu", [net.batch_bytes(nid) for nid in net.ids],
                   c2m.epochs_per_sec, net.queue_peaks(), c2m.messages_delivered))
    check(all(r[1] == c2[0][1] and r[4] == c2[0][4] for r in c2),
          "31c: config 2's native tier on the card != the host engine's batches")
    print(f"31c: config 2's native tier ({C2_NODES} nodes x {C2_EPOCHS} epochs), in turns: the same "
          f"batches on every node, {c2[0][4]} messages, 0 launches; epochs/s "
          f"{[(r[0], round(r[2], 2)) for r in c2]}, queue_peaks {c2[0][3]} {tag}")
    record["sim16_walls_s"] = [(r[0], r[2]) for r in runs]
    record["config2_native_epochs_per_sec"] = [(r[0], r[2]) for r in c2]
    record["config2_queue_peaks"] = c2[0][3]
    return record


def point_shape_rows(shapes, u: torch.Tensor, tag: str) -> list:
    """Each B2 launch shape of an epoch (ops/decrypt_torch.Launch rows):
    its device ms per launch at its lanes by CUDA events over back-to-back
    launches, beside its bound (`fq_torch.products` per lane, each element
    read or written once).  Operands are points of `u` repeated to the
    shape's lanes; a `mul` takes the shape's operand form."""
    from hydrabadger_tpu_torch.ops import fq_torch as fq, limbs

    n = u.shape[-1]
    beta = torch.as_tensor(limbs.BETA_MONT, device=u.device)[:, None]
    rows = []
    for r in shapes:
        k = -(-r.lanes // n)
        a = u.repeat(1, 1, k)[..., :r.lanes].contiguous()
        b = fq.jac_double_plain(a).roll(1, -1).contiguous()
        if r.name == "mul":
            other = {"a*b": b[1], "a*a": a[0], "a*const": beta}[r.form]
            fn = lambda: fq.fq_mul(a[0], other)  # noqa: E731
        elif r.name.startswith("win"):
            c = a.roll(3, -1).contiguous()
            fn = lambda: fq.window_step(a, b, c, int(r.name[3:]))  # noqa: E731
        elif r.name.startswith("dblk"):
            fn = lambda: fq.jac_double_k(a, int(r.name[4:]))  # noqa: E731
        else:
            entry = fq.ENTRIES[r.name][0]
            fn = (lambda: entry(a, b)) if r.name in ("add", "ladd") else (lambda: entry(a))
        ms = launch_ms(fn)
        prods = fq.products(r.name)
        o, by = roofline.product_ms(prods * r.lanes, r.elements * r.lanes)
        bound, what = roofline.bound_ms(o, by)
        rows.append({"entry": r.name, "form": r.form, "lanes": r.lanes, "per_epoch": r.count,
                     "products_per_lane": prods, "ms": ms, "bound_ms": bound, "bound_by": what})
        print(f"  fq_point {r.name}{' ' + r.form if r.form else ''} x {r.lanes} lanes "
              f"({r.count}/epoch): {ms:.4f} ms per launch, bound {bound:.5f} ms ({what}), "
              f"{ms / bound:.0f}x {tag}")
    return rows


def generic_epoch_plane(dev: torch.device, tag: str) -> tuple[dict, dict, torch.Tensor]:
    """Phase 32a-b: config 8's generic full-crypto epoch and decrypt_T's
    WIN_CIRCUIT=0 path on kernel B2.  Returns the records for B2's entry and
    instance 0's U_next through the plain versions (phase 33c's reference)."""
    from hydrabadger_tpu_torch.crypto import bls12_381 as bls
    from hydrabadger_tpu_torch.ops import bls_torch, limbs
    from hydrabadger_tpu_torch.ops import decrypt_torch as dt, fq_torch as fq
    from hydrabadger_tpu_torch.sim import tensor as ts

    # -- 32a. the generic epoch at bench.py's call ---------------------------
    cfg = ts.FullCryptoConfig(n_nodes=FC_NODES, instances=FC_INSTANCES, share_chunks=GEN_CHUNKS)
    n, q = cfg.instances * cfg.n_nodes, cfg.threshold + 1
    t0 = time.perf_counter()
    os.environ["HYDRABADGER_DECRYPT_T"] = "0"
    try:
        gen = ts.FullCryptoTensorSim(cfg, device=dev)
    finally:
        os.environ.pop("HYDRABADGER_DECRYPT_T", None)
    check(gen.generic and "glv_ladder" in gen.epoch.launch_counts()["fq_point"],
          "HYDRABADGER_DECRYPT_T=0 did not select the generic epoch")
    u0 = gen._U.clone()
    dec = ts.FullCryptoTensorSim.from_jax(gen.state(), gen._sks, gen._master, gen._quorum,
                                          device=dev)
    check(not dec.generic and dec.epoch.win_circuit, "unset did not select the decrypt engine")
    print(f"32a: generic epoch set-up {time.perf_counter() - t0:.2f} s: {cfg}, "
          f"{n} ciphertexts x {q + 1} lanes, {GEN_CHUNKS} chunks of "
          f"{n * (q + 1) // GEN_CHUNKS} lanes a stage")

    def same_points(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
        check(bool(dt.jac_eq(a, b, fq.fq_mul_plain)), f"{what}: not projectively equal")
        lanes = [0, 1, n // 2, n - 1]
        pa = limbs.limbs_to_points(a[..., lanes].cpu().numpy())
        pb = limbs.limbs_to_points(b[..., lanes].cpu().numpy())
        check(all(bls.eq(x, y) for x, y in zip(pa, pb)), f"{what}: sampled lanes differ")

    t0 = time.perf_counter()
    check(gen.run(1), "generic warm epoch: the check failed")
    warm_s = time.perf_counter() - t0
    check(dec.run(1), "decrypt engine's warm epoch: the check failed")
    same_points(gen._U, dec._U, "generic vs decrypt engine after the warm epoch")
    print(f"32a: warm epoch {warm_s:.3f} s; U_next projectively equal to the decrypt "
          f"engine's on all {n} lanes (plain products on the card) and on sampled lanes "
          f"(host points)")
    plain = ts.build_full_crypto_epoch(1, cfg.n_nodes, cfg.threshold, 1, dev, use_kernel=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_next, p_ok = plain(u0[..., :cfg.n_nodes].contiguous(), *gen._windows)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max_abs_err(p_next, gen._U[..., :cfg.n_nodes])
    check(bool(p_ok) and err == 0,
          f"instance 0 through the plain versions != the kernel path (max err {err})")
    print(f"32a: instance 0 ({cfg.n_nodes} ciphertexts) through the plain versions on the card "
          f"== the kernel path, limb for limb ({plain_s:.2f} s)")

    want = gen.epoch.launch_counts()
    zero_launches(dev)
    t0 = time.perf_counter()
    ok = gen.run(GEN_EPOCHS)  # one host sync, at the end
    gen_s = [time.perf_counter() - t0]
    by_kind, others = b2_launches(dev)
    check(ok, "generic main path: the check failed")
    expect = {k: v * GEN_EPOCHS for k, v in want["fq_point"].items()}
    check(by_kind == expect, f"generic epoch: B2 launches {by_kind}, launch_counts imply {expect}")
    check(sum(others.values()) == 0, f"generic epoch launched other kernels: {others}")
    sample = [0, n // 3, n - 1]
    check(gen.oracle_check(sample), "generic epoch: sampled lanes != the host oracle")
    print(f"32a: main path, {GEN_EPOCHS} epochs ok; B2 launches by entry {by_kind} == "
          f"{GEN_EPOCHS} x launch_counts {want['fq_point']}, no other kernel; lanes {sample} == "
          f"U + sum lam_i (U sk_i) (host oracle)")
    dec_s = []
    for sim, walls in ((dec, dec_s), (dec, dec_s), (gen, gen_s)):  # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(sim.run(GEN_EPOCHS), "timed run: the check failed")
        walls.append(time.perf_counter() - t0)
    same_points(gen._U, dec._U, "generic vs decrypt engine after the timed epochs")
    gen_eps = [GEN_EPOCHS / w for w in gen_s]
    dec_eps = [GEN_EPOCHS / w for w in dec_s]
    print(f"32a: epochs/s at {FC_NODES} x {FC_INSTANCES}: generic {[round(e, 3) for e in gen_eps]}, "
          f"decrypt engine {[round(e, 3) for e in dec_eps]} (in turns) {tag}")
    # each launch shape's device ms: the ladder at a chunk of each stage's
    # real digits, its bound from the whole stage's digits (bls_torch.glv_plan)
    s1 = torch.cat([gen._windows[0][:, :, :q], gen._windows[2]], 2)
    s2 = torch.cat([gen._windows[1], gen.epoch._one], 2)
    m = n * (q + 1) // GEN_CHUNKS
    lanes0 = u0[:, :, :, None].expand(3, limbs.N_LIMBS, n, q + 1).reshape(3, limbs.N_LIMBS, -1)
    x = lanes0[..., :m].contiguous()
    glv_ms, glv_ops, glv_bytes = [], 0.0, 0.0
    for stage in (s1, s2):
        d = gen.epoch.lane_digits(stage)
        dm = d[..., :m].contiguous()
        glv_ms.append(launch_ms(lambda: fq.glv_ladder(x, dm), reps=5, batches=3))
        o, by = bls_torch.glv_plan(d.cpu().numpy())[0].bound()
        glv_ops, glv_bytes = glv_ops + o, glv_bytes + by
    glv_bound, glv_by = roofline.bound_ms(glv_ops, glv_bytes)
    print(f"  fq_point glv_ladder x {m} lanes ({2 * GEN_CHUNKS}/epoch): stage 1 {glv_ms[0]:.4f}, "
          f"stage 2 {glv_ms[1]:.4f} ms per launch; both stages' bound {glv_bound:.5f} ms "
          f"({glv_by}) {tag}")
    rows = [{"entry": "glv_ladder", "lanes": m, "per_epoch": 2 * GEN_CHUNKS,
             "ms_stage1": glv_ms[0], "ms_stage2": glv_ms[1],
             "epoch_ms": GEN_CHUNKS * sum(glv_ms), "epoch_bound_ms": glv_bound,
             "bound_by": glv_by}]
    rest = point_shape_rows([r for r in gen.epoch.launch_shapes() if r.name != "glv_ladder"],
                            u0, tag)
    rows += rest
    dev_ms = rows[0]["epoch_ms"] + sum(r["ms"] * r["per_epoch"] for r in rest)
    bound = glv_bound + sum(r["bound_ms"] * r["per_epoch"] for r in rest)
    print(f"32a: generic epoch {1e3 / float(np.median(gen_eps)):.2f} ms wall; B2 {dev_ms:.3f} "
          f"device ms an epoch by shape ({sum(r['per_epoch'] for r in rows)} launches), bound "
          f"{bound:.4f} ms {tag}")
    generic = {"per": f"config 8's generic epoch (bench.py:792), {FC_NODES} x {FC_INSTANCES}, "
                      f"share_chunks={GEN_CHUNKS}",
               "launches": sum(by_kind.values()), "launches_by_entry": by_kind,
               "epochs_per_s": gen_eps, "decrypt_engine_epochs_per_s": dec_eps,
               "device_ms_per_epoch": dev_ms, "bound_ms_per_epoch": bound,
               "plain_instance_s": plain_s, "shapes": rows}

    # -- 32b. decrypt_T's WIN_CIRCUIT=0 path ---------------------------------
    os.environ["HYDRABADGER_WIN_CIRCUIT"] = "0"
    try:
        win = dt.build_epoch(n, [dec._sks[i] for i in dec._quorum], dec._lam, dec._mp1,
                             device=dev)
    finally:
        os.environ.pop("HYDRABADGER_WIN_CIRCUIT", None)
    check(not win.win_circuit and win.straus is None, "WIN_CIRCUIT=0 did not select the path")
    ref, ok_ref = dec.epoch(u0)
    check(bool(ok_ref), "circuit path: the check failed")
    w_next, ok_w = win(u0)  # warm
    check(bool(ok_w), "WIN_CIRCUIT=0 warm epoch: the check failed")
    want_w = win.launch_counts()
    zero_launches(dev)
    t0 = time.perf_counter()
    w_next, ok_w = win(u0)
    check(bool(ok_w), "WIN_CIRCUIT=0 epoch: the check failed")
    win_s = [time.perf_counter() - t0]
    w_kind, w_others = b2_launches(dev)
    check(w_others["circuit"] == 0 and sum(w_others.values()) == 0,
          f"WIN_CIRCUIT=0 epoch launched other kernels: {w_others}")
    check(w_kind == want_w["fq_point"] and want_w["circuit"] == {},
          f"WIN_CIRCUIT=0 epoch: B2 launches {w_kind}, launch_shapes imply {want_w}")
    same_points(w_next, ref, "WIN_CIRCUIT=0 vs the circuit path")
    limb_equal = torch.equal(w_next, ref)
    # B2's win6 at this path's width against its plain version, exactly:
    # GLV windows 0 (the accumulator at infinity) and 1 of the epoch's
    # ladder segments, on the operands the epoch gathers
    S = q + 1
    t1, t2 = win.dual_table(u0)
    acc = fq.jac_infinity(S * n, dev).reshape(3, limbs.N_LIMBS, S, n)
    win6_err = 0
    for j in range(2):
        s1, s2 = win.window_operands(t1, t2, j)
        got = fq.window_step(acc, s1, s2, dt.W1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fq.window_step_plain(acc, s1, s2, dt.W1)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        win6_err = max(win6_err, err)
        check(torch.equal(got, want),
              f"fq_point != plain at win6 [3, 12, {S}, {n}] window {j} (max err {err})")
        print(f"kernel == plain, exact: fq_point win6 [3, 12, {S}, {n}] ({S * n} lanes), GLV "
              f"window {j} of the WIN_CIRCUIT=0 epoch (plain {time.perf_counter() - t0:.2f} s)")
        acc = got
    del t1, t2, acc, got, want
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(bool(win(u0)[1]), "timed WIN_CIRCUIT=0 epoch: the check failed")
        win_s.append(time.perf_counter() - t0)
    win_eps = [1 / w for w in win_s]
    print(f"32b: WIN_CIRCUIT=0 epoch at {FC_NODES} x {FC_INSTANCES}: U_next projectively equal "
          f"to the circuit path's on all {n} lanes (limb for limb: {limb_equal}); 0 B3 launches, "
          f"B2 {sum(w_kind.values())} by entry {w_kind} == launch_counts; epochs/s "
          f"{[round(e, 3) for e in win_eps]} {tag}")
    w_rows = point_shape_rows(win.launch_shapes(), u0, tag)
    w_ms = sum(r["ms"] * r["per_epoch"] for r in w_rows)
    w_bound = sum(r["bound_ms"] * r["per_epoch"] for r in w_rows)
    print(f"32b: WIN_CIRCUIT=0 epoch: B2 {w_ms:.3f} device ms by shape, bound {w_bound:.4f} ms "
          f"{tag}")
    win_rec = {"per": f"decrypt_T's WIN_CIRCUIT=0 epoch, {FC_NODES} x {FC_INSTANCES}",
               "launches": sum(w_kind.values()), "launches_by_entry": w_kind,
               "epochs_per_s": win_eps, "device_ms_per_epoch": w_ms,
               "bound_ms_per_epoch": w_bound, "limb_equal_to_circuit_path": limb_equal,
               "win6_max_abs_err": win6_err, "shapes": w_rows}
    return generic, win_rec, p_next


def rs_fft_plane(dev: torch.device, tag: str) -> dict:
    """Phase 32c: the FFT route of RS on GpuEngine, config 10's RS sweep and
    the AFFT on the card.  Returns the record for B1's entry."""
    from hydrabadger_tpu_torch.crypto import _native
    from hydrabadger_tpu_torch.crypto.engine import CpuEngine, GpuEngine
    from hydrabadger_tpu_torch.crypto.rs import encode_matrix
    from hydrabadger_tpu_torch.ops import afft_torch, gf256_torch, ntt_torch, rs_fft

    rng = np.random.default_rng(32)
    eng, host = GpuEngine(device=dev), CpuEngine()
    k, p = RS_K, RS_P
    n = k + p
    data = rng.integers(0, 256, (RS_BATCH, k, SHARD_LEN), dtype=np.uint8)
    rows = list(range(p, n))  # the main path's parity quorum
    check(not eng._rs_route_ntt(k, p), "the GPU engine routed RS without the opt-in")
    zero_launches(dev)
    b1_enc = eng.rs_encode_batch(data, k, p)
    b1_rec = eng.rs_reconstruct_batch(b1_enc[:, p:n], rows, k, p)
    _, b1_others = b2_launches(dev)
    check(b1_others["gf256_matmul"] > 0, "the B1 route made no B1 launch")
    os.environ["HYDRABADGER_NTT_MIN_SHARDS"] = str(N_NODES)
    try:
        check(eng._rs_route_ntt(k, p), "HYDRABADGER_NTT_MIN_SHARDS did not route the engine")
        eng.rs_encode_batch(data, k, p)  # warm: plans, tables on the card
        zero_launches(dev)
        t0 = time.perf_counter()
        fft_enc = eng.rs_encode_batch(data, k, p)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fft_rec = eng.rs_reconstruct_batch(fft_enc[:, p:n], rows, k, p)
        rec_s = time.perf_counter() - t0
        _, f_others = b2_launches(dev)
    finally:
        os.environ.pop("HYDRABADGER_NTT_MIN_SHARDS", None)
    check(sum(f_others.values()) == 0, f"the FFT route launched kernels: {f_others}")
    host_enc = host.rs_encode_batch(data, k, p)
    host_rec = host.rs_reconstruct_batch(host_enc[:, p:n], rows, k, p)
    check(np.array_equal(fft_enc, b1_enc) and np.array_equal(fft_enc, host_enc),
          "FFT-route encode != the B1 route / the host codec")
    check(np.array_equal(fft_rec, b1_rec) and np.array_equal(fft_rec, host_rec)
          and np.array_equal(fft_rec, data), "FFT-route reconstruct != B1 / host / the data")
    print(f"32c: GpuEngine RS FFT route (HYDRABADGER_NTT_MIN_SHARDS={N_NODES}) at ({k}, {p}) x "
          f"{RS_BATCH} instances x {SHARD_LEN} B: encode {1e3 * enc_s:.2f} ms, reconstruct from "
          f"rows {p}..{n - 1} {1e3 * rec_s:.2f} ms (wall); bytes == the B1 route == the host "
          f"codec, no kernel launch on the route {tag}")

    sweep = []
    for nn in RS_SWEEP_N:
        f = (nn - 1) // 3
        kk, pp = nn - 2 * f, 2 * f
        d = rng.integers(0, 256, (kk, RS_SWEEP_L), dtype=np.uint8)
        mat = np.asarray(encode_matrix(kk, pp))[kk:]
        want = _native.gf_matmul(mat, d)
        got_host = rs_fft.encode_parity(d, kk, pp)
        got_card = rs_fft.encode_parity(d, kk, pp, dev)
        check(np.array_equal(got_host, want) and np.array_equal(got_card, want),
              f"config 10 sweep: the FFT route != the matrix route at n = {nn}")
        row = {"n": nn, "k": kk, "parity": pp,
               "matrix_native_ms": wall_ms(lambda: _native.gf_matmul(mat, d)),
               "fft_host_ms": wall_ms(lambda: rs_fft.encode_parity(d, kk, pp)),
               "fft_card_afft_ms": wall_ms(lambda: rs_fft.encode_parity(d, kk, pp, dev))}
        sweep.append(row)
    print(f"32c: config 10's RS sweep (broadcast geometry, L = {RS_SWEEP_L}), FFT == matrix at "
          f"every n; wall ms (median of 5): {sweep} {tag}")

    for m in range(1, 9):
        c = rng.integers(0, 256, (1 << m, 64, 12), dtype=np.uint8)
        fwd = afft_torch.afft_fwd(torch.from_numpy(c).to(dev), m)
        check(np.array_equal(fwd.cpu().numpy(), ntt_torch.gf_afft(c, m)),
              f"AFFT on the card != the numpy twin at m = {m}")
        inv = afft_torch.afft_inv(fwd, m)
        check(np.array_equal(inv.cpu().numpy(), c), f"AFFT inverse on the card at m = {m}")
    print("32c: ops/afft_torch on the card == ntt_torch.gf_afft / gf_iafft, byte for byte, "
          "m = 1..8")
    afft = []
    for label, tail in (("config 6 route", RS_BATCH * SHARD_LEN), ("config 10 sweep", RS_SWEEP_L)):
        c = rng.integers(0, 256, (256, tail), dtype=np.uint8)
        x = torch.from_numpy(c).to(dev)
        ms = timed_ms(lambda: afft_torch.afft_fwd(x, 8), 10)
        t0 = time.perf_counter()
        ntt_torch.gf_afft(c, 8)
        twin_ms = 1e3 * (time.perf_counter() - t0)
        _, by = roofline.ops_bytes_ms(0, 2 * c.size)
        afft.append({"shape": f"[256, {tail}]", "per": label, "ms": ms, "numpy_twin_ms": twin_ms,
                     "bound_ms": by, "bound_by": "bytes"})
        print(f"32c: afft_fwd m = 8 x {tail} lanes ({label}): {ms:.4f} device ms (CUDA events), "
              f"numpy twin {twin_ms:.2f} ms, bound {by:.5f} ms (bytes) {tag}")
    return {"per": f"GpuEngine RS FFT route at ({k}, {p}) x {RS_BATCH} x {SHARD_LEN}",
            "encode_ms": 1e3 * enc_s, "reconstruct_ms": 1e3 * rec_s, "b1_launches_on_route": 0,
            "config10_sweep": sweep, "afft": afft}


def b1_bound(launches) -> tuple[float, str]:
    """The bound of B1 launches given as (m, k, columns)."""
    ops = by = 0.0
    for m, k, cols in launches:
        o, b = roofline.gf_matmul_ms(m, k, cols)
        ops, by = ops + o, by + b
    return roofline.bound_ms(ops, by)


def mesh_plane(dev: torch.device, tag: str, phase4_state: torch.Tensor, phase4_epochs: int,
               plain_instance0: torch.Tensor) -> tuple[dict, dict, dict]:
    """Phase 33: parallel/mesh.py at world size 1 on NCCL, in this process.
    `plain_instance0` is phase 32a's instance 0 through the plain versions.
    Returns the records for B1's, B2's and B3's entries."""
    import tempfile

    import torch.distributed as dist

    from hydrabadger_tpu_torch.ops import circuit_torch, fq_torch, gf256_torch, pairing_torch
    from hydrabadger_tpu_torch.ops import rs_torch
    from hydrabadger_tpu_torch.parallel import mesh as pmesh
    from hydrabadger_tpu_torch.sim import tensor as ts

    def counted(fn):
        """fn() with every launch counter set to 0 just before and read just
        after: (result, wall ms, B2 by entry, B3 by circuit, every kernel's count)."""
        zero_launches(dev)
        circuit_torch.launches_by_circuit.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        by_kind, others = b2_launches(dev)
        others["fq_point"] = fq_torch.launches
        return out, wall, by_kind, dict(circuit_torch.launches_by_circuit), others

    def only(others: dict, **want) -> None:
        got = {k: v for k, v in others.items() if v}
        check(got == {k: v for k, v in want.items() if v}, f"launches {got}, want {want}")

    t_phase = time.perf_counter()
    k, p, n = MESH_K, MESH_P, MESH_K + MESH_P
    with tempfile.TemporaryDirectory(prefix="hb_mesh_") as tmp, \
            pmesh.process_group(os.path.join(tmp, "store"), 0, 1, "cuda") as mesh:
        check(mesh.size() == 1 and "nccl" in str(dist.get_backend()),
              f"phase 33 wants a world-1 NCCL mesh, got {mesh.size()} on {dist.get_backend()}")
        ar = torch.zeros(1, dtype=torch.int32, device=dev)
        reduce_ms = timed_ms(lambda: dist.all_reduce(ar, group=mesh.get_group()), 20)
        # -- 33a. the broadcast round --------------------------------------
        rng = np.random.default_rng(0)
        props = torch.from_numpy(rng.integers(0, 256, (n, k, MESH_L), dtype=np.uint8)).to(dev)
        pmesh.broadcast_round_sharded(props, k, p, mesh)  # warm: operands, NCCL's first call
        (received, decoded), a_wall, _, _, a_counts = counted(
            lambda: pmesh.broadcast_round_sharded(props, k, p, mesh))
        only(a_counts, gf256_matmul=2)
        # held against the plain versions of the round's two B1 launches,
        # at the round's own shapes: the encode over N * L columns, the
        # decode of the first k shard columns
        dec_op = rs_torch._decode_operand(k, p, tuple(range(k)), dev)
        plain_rx = rs_torch.rs_encode_batch(props, k, p, use_kernel=False)
        plain_dec = gf256_torch.gf_matmul_bits_plain(dec_op, received[:, :k])
        a_err = max(max_abs_err(received, plain_rx), max_abs_err(decoded, plain_dec))
        check(a_err == 0, f"33a: the round != its plain versions (max err {a_err})")
        check(torch.equal(decoded, props), "33a: decoded != the proposals")
        a_plain_ms = (timed_ms(lambda: rs_torch.rs_encode_batch(props, k, p, use_kernel=False), 5)
                      + timed_ms(lambda: gf256_torch.gf_matmul_bits_plain(dec_op, received[:, :k]),
                                 5))
        a_bound, a_by = b1_bound([(p, k, n * MESH_L), (k, k, n * MESH_L)])
        send = received.transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        parts = [torch.empty_like(received)]
        a2a_ms = timed_ms(lambda: dist.all_to_all_single(recv, send), 20)
        gather_ms = timed_ms(lambda: dist.all_gather(parts, received), 20)
        round_ms = timed_ms(lambda: pmesh.broadcast_round_sharded(props, k, p, mesh), 10)
        nbytes = received.numel()
        print(f"33a: broadcast_round_sharded at {n} nodes ({k}, {p}) x {MESH_L} B on a world-1 "
              f"NCCL mesh: received and decoded == the plain encode and decode byte for byte, "
              f"decoded == the proposals; 2 B1 launches, no other kernel; {a_wall:.2f} ms wall, "
              f"{round_ms:.4f} ms by events; plain (both launches) {a_plain_ms:.4f} ms, bound "
              f"{a_bound:.6f} ms ({a_by}); all_to_all_single {nbytes} B {a2a_ms:.4f} ms, "
              f"all_gather {nbytes} B {gather_ms:.4f} ms, all_reduce 4 B {reduce_ms:.4f} ms "
              f"(CUDA events) {tag}")
        round_rec = {"per": f"broadcast_round_sharded, {n} nodes ({k}, {p}) x {MESH_L} B, world 1",
                     "launches": a_counts["gf256_matmul"], "max_abs_err": a_err, "wall_ms": a_wall,
                     "events_ms": round_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound,
                     "bound_by": a_by,
                     "all_to_all_single": {"bytes": nbytes, "ms": a2a_ms},
                     "all_gather": {"bytes": nbytes, "ms": gather_ms}}
        del received, decoded, send, recv, parts, plain_rx, plain_dec
        # -- 33b. the instance-sharded encode (config 3's geometry) --------
        data = torch.from_numpy(
            rng.integers(0, 256, (MESH_INSTANCES, k, MESH_L), dtype=np.uint8)).to(dev)
        want = rs_torch.rs_encode_batch(data, k, p, use_kernel=False)
        enc, b_wall, _, _, b_counts = counted(
            lambda: pmesh.instances_sharded_encode(data, k, p, mesh))
        only(b_counts, gf256_matmul=1)
        b_err = max_abs_err(enc, want)
        check(b_err == 0, f"33b: instances_sharded_encode != the plain encode (max err {b_err})")
        enc_ms = timed_ms(lambda: pmesh.instances_sharded_encode(data, k, p, mesh), 10)
        b_plain_ms = timed_ms(lambda: rs_torch.rs_encode_batch(data, k, p, use_kernel=False), 5)
        b_bound, b_by = b1_bound([(p, k, MESH_INSTANCES * MESH_L)])
        print(f"33b: instances_sharded_encode at {MESH_INSTANCES} x ({k}, {p}) x {MESH_L} B == "
              f"the plain encode byte for byte; 1 B1 launch; {b_wall:.2f} ms wall, {enc_ms:.4f} ms "
              f"by events; plain {b_plain_ms:.4f} ms, bound {b_bound:.6f} ms ({b_by}) {tag}")
        encode_rec = {"per": f"instances_sharded_encode, {MESH_INSTANCES} x ({k}, {p}) x "
                             f"{MESH_L} B (config 3, bench.py:826), world 1",
                      "launches": b_counts["gf256_matmul"], "max_abs_err": b_err,
                      "wall_ms": b_wall, "events_ms": enc_ms, "plain_ms": b_plain_ms,
                      "bound_ms": b_bound, "bound_by": b_by}
        del data, want, enc
        # -- 33c. the node-sharded full-crypto epoch -----------------------
        cfg = ts.FullCryptoConfig(n_nodes=MESH_FC_NODES, instances=1, share_chunks=1)
        plan = ts.build_full_crypto_epoch(1, MESH_FC_NODES, cfg.threshold, 1, dev)
        (ok, U_next), c_wall, c_kind, _, c_counts = counted(
            lambda: pmesh._node_epoch(mesh, MESH_FC_NODES))
        check(ok, "33c: node-sharded epoch: the check failed")
        check(c_kind == plan.launch_counts()["fq_point"],
              f"33c: B2 by entry {c_kind}, launch_counts {plan.launch_counts()['fq_point']}")
        only(c_counts, fq_point=sum(c_kind.values()))
        os.environ["HYDRABADGER_DECRYPT_T"] = "0"
        try:
            gen = ts.FullCryptoTensorSim(cfg, device=dev)
        finally:
            os.environ.pop("HYDRABADGER_DECRYPT_T", None)
        check(gen.run(1) and torch.equal(U_next, gen._U),
              "33c: U_next != the unsharded generic epoch's")
        # phase 32a's instance 0 through the plain versions: the same seed,
        # keys and windows, so the same ciphertexts' U_next
        check(tuple(plain_instance0.shape) == tuple(U_next.shape),
              f"33c: 32a's plain instance {tuple(plain_instance0.shape)} is not this leg's "
              f"{tuple(U_next.shape)}")
        c_err = max_abs_err(U_next, plain_instance0)
        check(c_err == 0, f"33c: U_next != 32a's plain instance 0 (max err {c_err})")
        print(f"33c: full_crypto_epoch_node_sharded at {MESH_FC_NODES} nodes (t = "
              f"{cfg.threshold}): ok; B2 by entry {c_kind} == launch_counts, no other kernel; "
              f"U_next == the unsharded generic epoch's and 32a's plain instance 0, limb for limb; "
              f"{c_wall:.1f} ms wall {tag}")
        node_rec = {"per": f"full_crypto_epoch_node_sharded, {MESH_FC_NODES} nodes, world 1",
                    "launches": sum(c_kind.values()), "launches_by_entry": c_kind,
                    "max_abs_err": c_err,
                    "wall_ms": c_wall, "all_reduce_ms": reduce_ms}
        del gen
        # -- 33d. the instance-sharded full-crypto epoch -------------------
        cfg = ts.FullCryptoConfig(n_nodes=MESH_FC_NODES, instances=MESH_FC_INSTANCES,
                                  share_chunks=1)
        ref = ts.FullCryptoTensorSim(cfg, device=dev)
        want = ref.epoch.launch_counts()
        (ok, U_next), d_wall, d_kind, d_circ, d_counts = counted(
            lambda: pmesh._instance_epoch(mesh, MESH_FC_NODES, MESH_FC_INSTANCES))
        check(ok, "33d: instance-sharded epoch: the check failed")
        check(d_kind == want["fq_point"] and d_circ == want["circuit"],
              f"33d: launches B2 {d_kind} B3 {d_circ}, the decrypt engine's {want}")
        only(d_counts, fq_point=sum(d_kind.values()), circuit=sum(d_circ.values()))
        check(ref.run(1) and torch.equal(U_next, ref._U),
              "33d: U_next != the unsharded FullCryptoTensorSim's")
        lanes = MESH_FC_NODES * MESH_FC_INSTANCES
        sample = [0, 1, lanes // 2 + 3, lanes - 1]
        check(ref.oracle_check(sample), f"33d: lanes {sample} != the host oracle")
        print(f"33d: full_crypto_epoch_sharded at {MESH_FC_NODES} nodes x {MESH_FC_INSTANCES} "
              f"instances: ok; B2 {sum(d_kind.values())}, B3 {sum(d_circ.values())} launches == "
              f"the decrypt engine's launch_counts; U_next == the unsharded sim's limb for limb, "
              f"lanes {sample} == U + sum lam_i (U sk_i) (host oracle); {d_wall:.1f} ms wall {tag}")
        inst_b2 = {"per": f"full_crypto_epoch_sharded, {MESH_FC_NODES} x {MESH_FC_INSTANCES}, "
                          "world 1", "launches": sum(d_kind.values()),
                   "launches_by_entry": d_kind, "wall_ms": d_wall}
        inst_b3 = {"per": inst_b2["per"], "launches": sum(d_circ.values()),
                   "launches_by_circuit": d_circ, "wall_ms": d_wall}
        del ref
        # -- 33e. the sharded pairing checks -------------------------------
        t0 = time.perf_counter()
        pmesh.pairing_inputs(MESH_PAIRS)
        inputs_s = time.perf_counter() - t0
        checks = MESH_PAIRS if inputs_s < 10 else MESH_PAIRS // 4
        ok, e_wall, _, e_circ, e_counts = counted(lambda: pmesh.pairing_checks_sharded(mesh, checks))
        check(ok, "33e: pairing_checks_sharded: a check failed")
        check(e_circ == pairing_torch.schedule(checks),
              f"33e: B3 by circuit {e_circ}, schedule {pairing_torch.schedule(checks)}")
        only(e_counts, circuit=sum(e_circ.values()))
        print(f"33e: pairing_checks_sharded at {checks} checks (the inputs {inputs_s:.2f} s on the "
              f"host for {MESH_PAIRS}): ok; B3 {sum(e_circ.values())} launches == "
              f"pairing_torch.schedule; {e_wall:.1f} ms wall {tag}")
        pair_rec = {"per": f"pairing_checks_sharded, {checks} checks, world 1",
                    "launches": sum(e_circ.values()), "inputs_s": inputs_s, "wall_ms": e_wall}
        # -- 33f. the fast-path TensorSim, instance-sharded ----------------
        tcfg = ts.TensorSimConfig(n_nodes=N_NODES, instances=INSTANCES, shard_len=SHARD_LEN)
        per = tcfg.instances // mesh.size()  # the rank's instances, as in __graft_entry__.py
        lo, hi = mesh.get_local_rank() * per, (mesh.get_local_rank() + 1) * per
        start = torch.from_numpy(ts._initial_proposals(tcfg)[lo:hi]).to(dev)

        def fast_path():
            state, ok = ts.run_epochs(start, tcfg.data_shards, tcfg.parity_shards, phase4_epochs)
            return state, pmesh.all_ok(mesh, ok)

        (state, ok), f_wall, _, _, f_counts = counted(fast_path)
        check(ok, "33f: instance-sharded TensorSim: totality violated")
        only(f_counts, gf256_matmul=2 * phase4_epochs)
        check(torch.equal(state, phase4_state[lo:hi]), "33f: final state != phase 4's")
        print(f"33f: TensorSim at {N_NODES} x {INSTANCES} x {SHARD_LEN} B instance-sharded, "
              f"{phase4_epochs} epochs, totality reduced over the mesh: ok; final state == phase "
              f"4's unsharded run; {2 * phase4_epochs} B1 launches; {f_wall:.1f} ms wall "
              f"({1e3 * phase4_epochs / f_wall:.1f} epochs/s) {tag}")
        fast_rec = {"per": f"TensorSim {N_NODES} x {INSTANCES} x {SHARD_LEN} B, instance-sharded, "
                           f"{phase4_epochs} epochs, world 1",
                    "launches": f_counts["gf256_matmul"], "wall_ms": f_wall}
        # -- 33g. a mesh wider than the world ------------------------------
        try:
            pmesh.make_mesh(n_devices=2)
        except ValueError as exc:
            print(f"33g: make_mesh(n_devices=2) on one card raises: {exc}")
        else:
            raise SmokeFailure("33g: make_mesh(n_devices=2) did not raise on one card")
    check(not dist.is_initialized(), "phase 33 left its process group initialised")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 33: {phase_s:.1f} s {tag}")
    return ({"round": round_rec, "encode": encode_rec, "tensor_sim": fast_rec, "phase_s": phase_s},
            {"node_sharded": node_rec, "instance_sharded": inst_b2},
            {"instance_sharded": inst_b3, "pairing": pair_rec})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2

    from hydrabadger_tpu_torch.crypto import gf256
    from hydrabadger_tpu_torch.crypto.rs import decode_matrix, encode_matrix
    from hydrabadger_tpu_torch.ops import _kernels, circuit_torch, fq_torch, gf256_torch
    from hydrabadger_tpu_torch.sim import tensor as ts
    from hydrabadger_tpu_torch.utils import host_native

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # the plain version's float32 product must stay full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    tag = f"[{card}]"

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    host_error: list = []

    def build_host_native():  # g++ and gcc beside the nvcc builds
        try:
            host_native.build_all()
        except Exception as exc:  # re-raised below, on the main thread
            host_error.append(exc)

    gxx = threading.Thread(target=build_host_native)
    gxx.start()
    built = _kernels.build()
    gxx.join()
    if host_error:
        raise host_error[0]
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built) or 'none (cached)'}")
    for lib in host_native.LIBRARIES:
        print(f"  {lib.sources[0].relative_to(host_native.ROOT)} (host code, "
              f"{lib.dest.relative_to(host_native.ROOT)}): "
              + (f"{lib.cc()} {lib.build_seconds:.2f} s" if lib.build_seconds is not None
                 else "an earlier build, reused"))
    for name, (seconds, output) in built.items():
        print(f"  {name}: nvcc {seconds:.2f} s")
        for entry, regs, stores, loads in ptxas_report(output):
            print(f"    {entry}: {regs} registers, spill stores {stores} B, spill loads {loads} B")
    for name in _kernels.LIBRARIES:
        _kernels.load(name)
    print(f"  gf256_matmul SASS, tensor-core instructions: {sass_mma_counts(_kernels)}")

    # -- 3. kernels against their plain versions -----------------------------
    cfg = ts.TensorSimConfig(n_nodes=N_NODES, instances=INSTANCES, shard_len=SHARD_LEN)
    k, p = cfg.data_shards, cfg.parity_shards
    n = k + p
    B = INSTANCES * N_NODES  # B*L = 786,432 byte columns per call
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 256, (B, k, SHARD_LEN), dtype=np.uint8)).to(dev)
    rows = tuple(range(p, n))
    enc_op = gf256_torch.operand(encode_matrix(k, p)[k:], dev)
    dec_op = gf256_torch.operand(decode_matrix(k, p, rows), dev)
    worst = 0

    def hold(op, x, label, out=None):
        nonlocal worst
        got = gf256_torch.gf_matmul(op, x, out=out)
        want = gf256_torch.gf_matmul_bits_plain(op, x)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"gf256_matmul != plain at {label} (max err {err})")
        print(f"kernel == plain, exact: {label}")
        return got

    parity = hold(enc_op, data, f"encode ({p},{k}) x [{B},{k},{SHARD_LEN}]")
    codeword = torch.cat([data, parity], dim=1)  # [B, n, L]
    survivors = codeword[:, p:n]  # the main path's strided view
    recovered = hold(dec_op, survivors, f"reconstruct ({k},{k}) x strided [{B},{k},{SHARD_LEN}] view")
    check(torch.equal(recovered, data), "reconstruct did not recover the data rows")
    into = torch.zeros((B, n, SHARD_LEN), dtype=torch.uint8, device=dev)
    hold(enc_op, data, "encode into the codeword's parity rows (strided out)", out=into[:, k:])
    shifted = torch.zeros((B, k, SHARD_LEN + 1), dtype=torch.uint8, device=dev)
    shifted[:, :, 1:] = data  # a view at an odd address: the byte-by-byte path
    bytewise = hold(enc_op, shifted[:, :, 1:], "encode from an unaligned view (byte path)")
    check(torch.equal(bytewise, parity), "byte path != word path")
    rag_mat = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    rag = torch.from_numpy(rng.integers(0, 256, (5, 1013), dtype=np.uint8)).to(dev)
    rag_out = hold(gf256_torch.operand(rag_mat, dev), rag, "ragged (3,5) x [5,1013]")
    check(np.array_equal(rag_out.cpu().numpy(), gf256.matmul(rag_mat, rag.cpu().numpy())),
          "ragged kernel != numpy gf256.matmul")
    rag3 = torch.from_numpy(rng.integers(0, 256, (3, 5, 1013), dtype=np.uint8)).to(dev)
    hold(gf256_torch.operand(rag_mat, dev), rag3, "ragged (3,5) x [3,5,1013]")
    # the 4-node engine shape, several launches over row chunks of A, and
    # many K tiles per launch; each also against numpy on sampled rows
    for m_, k_, b_, l_ in ((2, 2, 4096, 64), (233, 22, 64, 12), (32, 223, 64, 12)):
        mat = rng.integers(0, 256, (m_, k_), dtype=np.uint8)
        x = torch.from_numpy(rng.integers(0, 256, (b_, k_, l_), dtype=np.uint8)).to(dev)
        got = hold(gf256_torch.operand(mat, dev), x, f"({m_},{k_}) x [{b_},{k_},{l_}], "
                   f"{len(gf256_torch.chunks(m_, k_))} launch(es)")
        for b in (0, b_ // 2, b_ - 1):
            check(np.array_equal(got[b].cpu().numpy(), gf256.matmul(mat, x[b].cpu().numpy())),
                  f"({m_},{k_}) kernel != numpy gf256.matmul at batch row {b}")
    sample = [0, 1, B // 2, B - 1]
    host_data = data[sample].cpu().numpy()
    host_par = parity[sample].cpu().numpy()
    host_rec = recovered[sample].cpu().numpy()
    for i in range(len(sample)):
        check(np.array_equal(host_par[i], gf256.matmul(encode_matrix(k, p)[k:], host_data[i])),
              "encode kernel != numpy gf256.matmul on a sampled instance")
        check(np.array_equal(host_rec[i], host_data[i]), "sampled reconstruct != data")
    print(f"kernel == numpy gf256.matmul on sampled instances {sample}")

    def hold_on_path(op, x, label, path, out=None):
        before = dict(gf256_torch.launches_by_path)
        got = hold(op, x, label, out=out)
        moved = {key: gf256_torch.launches_by_path[key] - before[key] for key in before}
        check(moved == {**dict.fromkeys(before, 0), path: 1},
              f"{label}: launches by path {moved}, want one on the {path} path")
        return got

    bL = BATCH64K_SHARD_LEN
    b_data = torch.from_numpy(rng.integers(0, 256, (N_NODES, k, bL), dtype=np.uint8)).to(dev)
    b_code = torch.zeros((N_NODES, n, bL), dtype=torch.uint8, device=dev)
    b_code[:, :k] = b_data
    hold_on_path(enc_op, b_data, f"rs64-batch64k's encode ({p},{k}) x [{N_NODES},{k},{bL}] "
                 "into the codeword's parity rows", "rows", out=b_code[:, k:])
    check(torch.equal(b_code[:, :k], b_data), "the encode wrote outside the parity rows")
    b_rec = hold_on_path(dec_op, b_code[:, p:n], f"rs64-batch64k's reconstruct ({k},{k}) from "
                         f"the quorum view, {p * bL} bytes into each row", "rows")
    check(torch.equal(b_rec, b_data), "rs64-batch64k's reconstruct did not recover the data")
    print("rs64-batch64k's two launches: one each, on the row path")

    # -- 4. the main path --------------------------------------------------
    sim = ts.TensorSim(cfg, device="cuda")
    plain = ts.TensorSim(cfg, device="cuda", use_kernel=False)
    check(sim.run(2), "warm-up epochs: totality violated")
    check(plain.run(2), "plain warm-up epochs: totality violated")
    torch.cuda.synchronize()

    gf256_torch.launches, fq_torch.launches, circuit_torch.launches = 0, 0, 0
    paths = dict(gf256_torch.launches_by_path)
    t0 = time.perf_counter()
    ok = sim.run(EPOCHS)  # one host sync, at the end
    main_s = time.perf_counter() - t0
    counts = {"gf256_matmul": gf256_torch.launches, "fq_point": fq_torch.launches,
              "circuit": circuit_torch.launches}
    words = gf256_torch.launches_by_path["words"] - paths["words"]
    check(ok, "main path: totality violated")
    check(counts["gf256_matmul"] == 2 * EPOCHS == words,
          f"main path made {counts['gf256_matmul']} gf256_matmul launches ({words} on the word "
          f"path), want {2 * EPOCHS} on it")
    print(f"main path: {EPOCHS} epochs ok, launches {counts}, all on the word path")

    check(plain.run(EPOCHS), "plain main path: totality violated")
    check(torch.equal(sim._state, plain._state), "final state != the plain version's")
    print("final state == the same epochs through the plain version")

    idx = [0, INSTANCES // 3, INSTANCES - 1]
    sampled = sim._state[idx].contiguous()
    decoded, ok_s = ts.epoch(sampled, k, p)
    oracle = ts.cpu_fast_path_epoch(sampled.cpu().numpy(), k, p)
    check(bool(ok_s.all()), "sampled epoch: totality violated")
    check(np.array_equal(decoded.cpu().numpy(), oracle), "sampled epoch != cpu_fast_path_epoch")
    print(f"one epoch of instances {idx} == cpu_fast_path_epoch")

    b_cfg = ts.TensorSimConfig(n_nodes=N_NODES, instances=1, shard_len=BATCH64K_SHARD_LEN)
    b_sim = ts.TensorSim(b_cfg, device="cuda")
    b_plain = ts.TensorSim(b_cfg, device="cuda", use_kernel=False)
    gf256_torch.launches = 0
    gf256_torch.launches_by_path.update(dict.fromkeys(gf256_torch.launches_by_path, 0))
    check(b_sim.run(BATCH64K_EPOCHS), "rs64-batch64k's geometry: totality violated")
    b_paths = dict(gf256_torch.launches_by_path)
    want = {"words": 0, "rows": 2 * BATCH64K_EPOCHS, "bytes": 0}
    check(gf256_torch.launches == 2 * BATCH64K_EPOCHS and b_paths == want,
          f"rs64-batch64k's geometry: {gf256_torch.launches} gf256_matmul launches, by path "
          f"{b_paths}, want {want}")
    check(b_plain.run(BATCH64K_EPOCHS), "plain rs64-batch64k geometry: totality violated")
    check(torch.equal(b_sim._state, b_plain._state),
          "rs64-batch64k's geometry: final state != the plain version's")
    print(f"rs64-batch64k's geometry: {BATCH64K_EPOCHS} epochs ok, launches by path {b_paths}, "
          "final state == the plain version's")

    # -- 5. timings --------------------------------------------------------
    eps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(sim.run(EPOCHS), "timed run: totality violated")
        eps.append(EPOCHS / (time.perf_counter() - t0))
    print(f"epochs/s at {N_NODES} nodes x {INSTANCES} instances: main path "
          f"{EPOCHS / main_s:.2f}, timed runs {[round(e, 2) for e in eps]} {tag}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cols = B * SHARD_LEN
    shapes = []
    # the earlier SWAR form of B1 (logic ops on the integer units), H100 80GB
    # HBM3 at 700 W, timed as here (PERF.md)
    swar_ms = {"encode": 0.1517, "reconstruct": 0.0846}
    for label, op, x in (("encode", enc_op, data), ("reconstruct", dec_op, survivors)):
        m = op.shape[0]
        out = torch.empty((B, m, SHARD_LEN), dtype=torch.uint8, device=dev)
        ms = timed_ms(lambda: gf256_torch._launch(op, x, out), 20, flush)
        plain_ms = timed_ms(lambda: gf256_torch.gf_matmul_bits_plain(op, x), 5, flush)
        a16 = op.abits.to(torch.bfloat16)
        x16 = torch.randint(0, 2, (8 * k, cols), device=dev).to(torch.bfloat16)
        yard_ms = timed_ms(lambda: torch.matmul(a16, x16), 10, flush)
        del x16
        ops_ms, bytes_ms = roofline.gf_matmul_ms(m, k, cols)
        bound = max(bytes_ms, ops_ms)
        shapes.append({
            "shape": label, "m": m, "k": k, "cols": cols, "ms": ms, "plain_ms": plain_ms,
            "matmul_bf16_yardstick_ms": yard_ms, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "bound_ms": bound, "ms_over_bound": ms / bound,
            "swar_kernel_ms": swar_ms[label],
        })
        print(f"gf256_matmul {label} ({m},{k}) x {cols} cols: kernel {ms:.4f} ms "
              f"({ms / bound:.2f}x its bound; the SWAR kernel {swar_ms[label]:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bf16 matmul yardstick {yard_ms:.4f} ms, bound "
              f"{bound:.4f} ms (bytes {bytes_ms:.4f}, int8 ops {ops_ms:.4f}) {tag}")
    del flush
    epoch_ms = 1e3 / float(np.median(eps))
    kernel_ms = sum(s["ms"] for s in shapes)
    print(f"epoch {epoch_ms:.4f} ms, of which the two gf256_matmul launches "
          f"{kernel_ms:.4f} ms ({100 * kernel_ms / epoch_ms:.1f}%; the SWAR kernel "
          f"{sum(swar_ms.values()):.4f} ms) {tag}")
    print(json.dumps({"shapes": shapes, "card": card}))

    ops_total = sum(s["ops_bound_ms"] for s in shapes)
    bytes_total = sum(s["bytes_bound_ms"] for s in shapes)
    kernels = [{
        "name": "gf256_matmul",
        "route": "cuda",
        "source": "hydrabadger_tpu_torch/csrc/gf256_matmul.cu",
        "replaces": "hydrabadger_tpu/ops/gf256_jax.py:148",
        "launches": counts["gf256_matmul"],
        "max_abs_err": worst,
        "per": f"one epoch: encode ({p},{k}) + reconstruct ({k},{k}), {cols} columns each",
        "ms": kernel_ms,
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": max(ops_total, bytes_total),
        "bound_by": "operations" if ops_total >= bytes_total else "bytes",
        "library_ms": None,
    }]
    kernels += full_crypto(dev, tag)
    kernels.append(coin_plane(dev, tag))
    kernels.append(fp_probes(dev, tag))
    fq_entry = next(k for k in kernels if k["name"] == "fq_point")
    fq_entry["decrypt_round"] = decrypt_plane(dev, tag)
    kernels[0]["sim"], sketch_err = sim_plane(dev, tag)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], sketch_err)
    fq_entry["dhb_era_switch"] = dkg_plane(dev, tag)
    fq_entry["max_abs_err"] = max(fq_entry["max_abs_err"], fq_entry["dhb_era_switch"]["max_abs_err"])
    fq_entry["tcp_config1"], kernels[0]["tcp_lowcomm"], tcp_err = tcp_plane(dev, tag)
    fq_entry["max_abs_err"] = max(fq_entry["max_abs_err"], tcp_err)
    b3_entry = next(k for k in kernels if k["name"] == "circuit")
    b3_entry["pairing"], pair_err = pairing_plane(dev, tag)
    b3_entry["max_abs_err"] = max(b3_entry["max_abs_err"], pair_err)
    # -- 28. the process tier on the card ----------------------------------
    fq_entry["resume"] = era_switch_resume(dev, tag, DKG_NODES)
    fq_entry["tcp_restart"] = tcp_restart(dev, tag)
    # -- 29. the adversarial plane on the card ------------------------------
    kernels[0]["attack"], fq_entry["attack_era_switch"], fq_entry["chaos_cluster"], attack_err = \
        adversarial_plane(dev, tag)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], attack_err)
    # -- 30. the process tier, part 2: config 13 and the soak tiers ---------
    t30 = time.perf_counter()
    fq_entry["process_cluster"] = process_cluster(dev, tag)
    kernels[0]["soak_rbc"], fq_entry["soak_era"], fq_entry["soak_tcp"] = soak_tiers(dev, tag)
    print(f"phase 30: {time.perf_counter() - t30:.1f} s {tag}")
    # -- 31. the native host cores: config 5 at 64 nodes, config 2's native tier
    t31 = time.perf_counter()
    fq_entry["config5_64node"] = native_cores(dev, tag)
    print(f"phase 31: {time.perf_counter() - t31:.1f} s {tag}")
    # -- 32. the generic full-crypto epoch, WIN_CIRCUIT=0, the RS FFT route --
    t32 = time.perf_counter()
    fq_entry["generic_epoch"], fq_entry["win_circuit0_epoch"], plain_instance0 = \
        generic_epoch_plane(dev, tag)
    fq_entry["max_abs_err"] = max(fq_entry["max_abs_err"],
                                  fq_entry["win_circuit0_epoch"]["win6_max_abs_err"])
    kernels[0]["rs_fft_route"] = rs_fft_plane(dev, tag)
    print(f"phase 32: {time.perf_counter() - t32:.1f} s {tag}")
    # -- 33. the mesh at world size 1 on NCCL --------------------------------
    kernels[0]["mesh"], fq_entry["mesh"], b3_entry["mesh"] = mesh_plane(
        dev, tag, plain._state, 2 + EPOCHS, plain_instance0)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s {tag}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
