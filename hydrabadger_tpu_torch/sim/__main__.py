"""CLI for the port's in-process simulator.

    python -m hydrabadger_tpu_torch.sim --nodes 16 --epochs 3 --rbc lowcomm
    python -m hydrabadger_tpu_torch.sim --engine cpu --nodes 4 --epochs 3 --json
    python -m hydrabadger_tpu_torch.sim --engine cpu --nodes 4 --epochs 1 \
        --encrypt --coin threshold --verify --json
    python -m hydrabadger_tpu_torch.sim --protocol dhb --engine cpu --nodes 4 --epochs 2
    python -m hydrabadger_tpu_torch.sim --protocol dhb --gpu-dkg --nodes 16 --epochs 2
    python -m hydrabadger_tpu_torch.sim --engine cpu --nodes 4 --epochs 2 --crash 3 \
        --meter-bytes --trace /tmp/sim.jsonl --metrics /tmp/sim-metrics.json
    python -m hydrabadger_tpu_torch.sim --engine cpu --nodes 4 --epochs 100 \
        --checkpoint /tmp/sim.ckpt --checkpoint-every 25
    python -m hydrabadger_tpu_torch.sim --resume /tmp/sim.ckpt --epochs 50
    python -m hydrabadger_tpu_torch.sim --engine cpu --nodes 4 --epochs 3 --encrypt \
        --coin threshold --verify --attack -1 --json

The JAX CLI's flags, plus `--engine {gpu,cpu}` (default gpu, which raises without a card),
`--device` (the GPU engine's card) and `--gpu-dkg` / `--no-gpu-dkg` (force
the DKG's device plane on or off for a dhb run; by default the
environment's HYDRABADGER_GPU_DKG decides).  `--resume` runs the
checkpointed sim as it was built: its engine, device and DKG plane with it.
`--attack F` runs the Byzantine scenario plane (the last F nodes run the
attack catalog, F = -1 for (n - 1) // 3) and verifies the
fault-observability contract at exit.  Exits 0 if and only if agreement
held.
"""
from __future__ import annotations

import argparse
import json
import sys

from .. import checkpoint as ckpt_mod
from ..crypto.engine import GpuEngine
from ..obs import export
from ..obs.metrics import default_registry
from .scenario import attack_spec
from .network import (
    SimConfig,
    SimNetwork,
    byzantine_adversary,
    crash_adversary,
    delay_adversary,
    drop_adversary,
    duplicate_adversary,
)


def _node_list(spec: str, n: int):
    """"I,J,..." -> sim node ids, each index checked against n."""
    ids = []
    for part in spec.split(","):
        idx = int(part)
        if not 0 <= idx < n:
            raise ValueError(f"node index {idx} out of range (n={n})")
        ids.append(f"n{idx:03d}")
    return ids


def _config(args, adversary, scenario) -> SimConfig:
    """The SimConfig of a fresh run from the CLI's flags."""
    engine = GpuEngine(device=args.device) if args.engine == "gpu" else "cpu"
    return SimConfig(
        n_nodes=args.nodes,
        protocol=args.protocol,
        epochs=args.epochs,
        txns_per_node_per_epoch=args.txns,
        txn_bytes=args.txn_bytes,
        batch_size=args.batch_size,
        encrypt=args.encrypt,
        coin_mode=args.coin,
        verify_shares=args.verify,
        engine=engine,
        seed=args.seed,
        adversary=adversary,
        scenario=scenario,
        trace=bool(args.trace),
        rbc_variant=args.rbc,
        meter_bytes=args.meter_bytes,
        tpu_dkg=args.gpu_dkg,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="hydrabadger_tpu_torch in-process simulator")
    p.add_argument("--nodes", type=int, default=16)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--protocol", choices=["qhb", "dhb"], default="qhb")
    p.add_argument("--txns", type=int, default=5, help="txns per node per epoch")
    p.add_argument("--txn-bytes", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--encrypt", action="store_true", help="threshold-encrypt contributions")
    p.add_argument("--coin", choices=["hash", "threshold"], default="hash")
    p.add_argument("--verify", action="store_true", help="verify crypto shares")
    p.add_argument("--engine", choices=["gpu", "cpu"], default="gpu",
                   help="CryptoEngine of the consensus cores (gpu raises without a card)")
    p.add_argument("--device", default="cuda", help="the gpu engine's torch device")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drop", type=float, default=0.0, help="message drop rate")
    p.add_argument("--dup", type=float, default=0.0, help="message duplication rate")
    p.add_argument("--delay", type=float, default=0.0, help="message delay rate")
    p.add_argument("--crash", default=None, metavar="I,J,...",
                   help="fail-stop these node indices (silenced from the start)")
    p.add_argument("--byzantine", default=None, metavar="I,J,...",
                   help="these node indices replay old messages alongside real traffic")
    p.add_argument("--attack", type=int, default=None, metavar="F",
                   help="Byzantine scenario plane: the LAST F nodes run the attack catalog "
                        "(equivocating RBC, withheld and garbage decryption shares, replay "
                        "floods: sim/byzantine.py); the fault-observability contract is "
                        "verified at exit.  Combine with --encrypt --verify so forged shares "
                        "travel the verify plane.  --attack -1 takes F = (n-1)//3")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record consensus spans and write them on exit: .jsonl -> one event "
                        "per line, anything else -> Chrome trace JSON")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="write the sim's metrics registry, the process registry and the "
                        "queue peaks as JSON on exit")
    p.add_argument("--meter-bytes", action="store_true",
                   help="price every router send and delivery at its codec wire size")
    p.add_argument("--rbc", choices=["bracha", "lowcomm"], default=None,
                   help="reliable-broadcast variant (default: HYDRABADGER_RBC or bracha)")
    p.add_argument("--gpu-dkg", action=argparse.BooleanOptionalAction, default=None,
                   help="force the DKG's device plane (kernel B2) on or off for each epoch")
    p.add_argument("--json", action="store_true", help="emit metrics as JSON")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write a full-state sim checkpoint when the run finishes")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N epochs during the run")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="resume from a sim checkpoint instead of starting fresh (--epochs "
                        "counts additional epochs; topology, engine and device flags are "
                        "ignored). WARNING: sim checkpoints restore via pickle — only resume "
                        "files from your own trust domain, or set HYDRABADGER_CKPT_KEY on both "
                        "ends to require an authenticated (HMAC) checkpoint")
    args = p.parse_args(argv)
    if args.nodes < 1:
        p.error("--nodes must be >= 1")
    if args.epochs < 1:
        p.error("--epochs must be >= 1")
    for name in ("drop", "dup", "delay"):
        if not 0.0 <= getattr(args, name) <= 1.0:
            p.error(f"--{name} must be in [0, 1]")
    faults = [f"--{n}" for n in ("drop", "dup", "delay") if getattr(args, n) > 0]
    faults += [f"--{n}" for n in ("crash", "byzantine", "attack") if getattr(args, n) is not None]
    if len(faults) > 1:
        p.error(f"{' and '.join(faults)} are mutually exclusive (one adversary schedule per run)")
    if args.checkpoint_every and not args.checkpoint:
        p.error("--checkpoint-every requires --checkpoint")
    if args.resume and args.trace:
        # a resumed SimNetwork's cores were built (and pickled) with the
        # checkpoint's recorder bindings — a fresh recorder could not be
        # rebound into them, so the flag would silently record nothing
        p.error("--trace is not supported with --resume (trace the original run instead)")
    if args.attack is not None and (args.resume or args.checkpoint):
        # a ScenarioSpec compiles into node wrappers at construction time;
        # checkpoint.sim_to_bytes refuses such a sim on the save side too
        p.error("--attack is not supported with --resume/--checkpoint")
    if args.attack is not None and args.encrypt and not args.verify:
        # unverified garbage shares would be absorbed silently and the
        # contract would fail at exit: refuse the config with its cause
        p.error("--attack with --encrypt requires --verify (forged decryption shares must "
                "travel the verify plane)")
    # --crash/--byzantine indices are checked against the sim that will
    # run: on --resume that is the checkpointed topology, not --nodes
    n_nodes = args.nodes
    resumed = None
    if args.resume:
        # with a fault flag a fresh adversary replaces the checkpoint's;
        # without one, a checkpoint that ran adversarially refuses to load
        # (callables are not serialized)
        resumed = ckpt_mod.load_sim(args.resume, adversary="pending" if faults else None)
        n_nodes = resumed.cfg.n_nodes
    adversary = scenario = None
    try:
        if args.attack is not None:
            scenario = attack_spec(args.nodes, None if args.attack < 0 else args.attack,
                                   seed=args.seed)
        if args.drop > 0:
            adversary = drop_adversary(args.drop, args.seed)
        elif args.dup > 0:
            adversary = duplicate_adversary(args.dup, args.seed)
        elif args.delay > 0:
            adversary = delay_adversary(args.delay, seed=args.seed)
        elif args.crash is not None:
            adversary = crash_adversary(_node_list(args.crash, n_nodes))
        elif args.byzantine is not None:
            adversary = byzantine_adversary(_node_list(args.byzantine, n_nodes),
                                            seed=args.seed)
    except ValueError as exc:
        p.error(str(exc))
    if resumed is not None:
        net = resumed
        net.cfg.adversary = net.router.adversary = adversary
    else:
        net = SimNetwork(_config(args, adversary, scenario))
    if args.checkpoint and args.checkpoint_every:
        remaining = args.epochs
        while remaining > 0:
            chunk = min(args.checkpoint_every, remaining)
            metrics = net.run(chunk)
            remaining -= chunk
            ckpt_mod.save_sim(args.checkpoint, net)
    else:
        metrics = net.run(args.epochs)
        if args.checkpoint:
            ckpt_mod.save_sim(args.checkpoint, net)
    if scenario is not None:
        # the fault-observability contract: every injected kind surfaced
        net.verify_scenario()
        net.shutdown()
        print("attack scenario verified: injected "
              + json.dumps(net.scenario_log.counts, sort_keys=True), file=sys.stderr)
    if args.trace:
        meta = {"clock_domain": net.recorder.clock_domain}
        write = export.write_jsonl if args.trace.endswith(".jsonl") else export.write_chrome_trace
        n = write(net.recorder.events, args.trace, meta=meta)
        print(f"trace: {n} events -> {args.trace}", file=sys.stderr)
    if args.metrics:
        with open(args.metrics, "w") as fh:
            json.dump({"sim": net.metrics.snapshot(), "process": default_registry().snapshot(),
                       "queue_peaks": net.queue_peaks()}, fh, indent=1)
        print(f"metrics -> {args.metrics}", file=sys.stderr)
    if args.json:
        print(json.dumps(metrics.as_dict()))
    else:
        for k, v in metrics.as_dict().items():
            print(f"{k:>20}: {v}")
    return 0 if metrics.agreement_ok else 1


if __name__ == "__main__":
    sys.exit(main())
