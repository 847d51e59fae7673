"""peer-node CLI: run one consensus node over TCP.

The port's copy of the JAX package's node CLI (hydrabadger_tpu/__main__.py),
flag-for-flag parity with the reference binary (src/bin/peer_node.rs:21-78):

    python -m hydrabadger_tpu_torch -b 127.0.0.1:3000 \
        -r 127.0.0.1:3001 -r 127.0.0.1:3002
    python -m hydrabadger_tpu_torch --engine cpu -b 127.0.0.1:3000 ...

`--engine {gpu,cpu}` defaults to gpu, the card (it raises without one), and
`--device` names the gpu engine's card.  `--checkpoint PATH` persists a
generational node checkpoint every `--checkpoint-every` committed epochs and
on a graceful stop, and resumes from its newest loadable generation at boot;
`--flight [DIR|PREFIX]` mounts the flight recorder (obs/flight.py).

Environment: HYDRABADGER_LOG sets the log level/filters the way the
reference's env_logger setup does (peer_node.rs:110-122) — e.g.
``HYDRABADGER_LOG=info`` or ``HYDRABADGER_LOG=hydrabadger_tpu_torch.net=debug``.
"""
from __future__ import annotations

import argparse
import asyncio
import random
import sys
from typing import List

from .crypto.engine import named_engine
from .net.node import Config, Hydrabadger
from .obs import logging as obs_logging
from .utils.ids import InAddr, OutAddr

# default flight-recorder directory; ONE constant serves both the argparse
# const and the directory-vs-prefix branch below
FLIGHT_DEFAULT_DIR = "tmp/obs"


def _append_line(path: str, line: str) -> None:
    """One jsonl append + flush — the executor-offloaded half of the
    feed writers: rows are BUILT on the loop (consensus/metrics state
    mutates under it) and handed here by value, so the disk open/flush
    never stalls the wire pumps.  Callers await each write, keeping rows
    in commit order."""
    with open(path, "a") as fh:
        fh.write(line + "\n")
        fh.flush()


def _parse_addr(spec: str):
    host, _, port = spec.rpartition(":")
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError(f"bad address {spec!r} (want host:port)")
    return host, int(port)


def setup_logging() -> None:
    """HYDRABADGER_LOG: either a bare level or comma-separated
    `module=level` filters (the reference's filter recipe, gdb-node:27).
    The parsing lives in obs.logging now — the net plane's structured
    logger — with levels and filters preserved."""
    obs_logging.setup_from_env("info")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hydrabadger_tpu_torch",
        description="a hydrabadger consensus node (reference: peer_node.rs)",
    )
    p.add_argument(
        "-b",
        "--bind-address",
        type=_parse_addr,
        default=("127.0.0.1", 3010),
        metavar="HOST:PORT",
        help="the socket address to listen on (peer_node.rs:27-33)",
    )
    p.add_argument(
        "-r",
        "--remote-address",
        type=_parse_addr,
        action="append",
        default=[],
        metavar="HOST:PORT",
        help="peer(s) to dial; repeatable (peer_node.rs:34-40)",
    )
    # declared-but-dead in the reference (peer_node.rs:41-45: parsed, never
    # read); here it caps generated-contribution size for real
    p.add_argument("--batch-size", type=int, default=150)
    p.add_argument(
        "--txn-gen-count",
        type=int,
        default=5,
        help="transactions generated per interval (hydrabadger.rs:36)",
    )
    p.add_argument(
        "--txn-gen-interval",
        type=int,
        default=5000,
        metavar="MS",
        help="generation interval in ms (hydrabadger.rs:38)",
    )
    p.add_argument(
        "--txn-gen-bytes",
        type=int,
        default=2,
        help="size of each random transaction (hydrabadger.rs:40)",
    )
    p.add_argument(
        "--keygen-node-count",
        type=int,
        default=3,
        metavar="N",
        help="nodes required to start key generation; maps to "
        "keygen_peer_count = N-1 (peer_node.rs:158-163)",
    )
    p.add_argument(
        "--output-extra-delay",
        type=int,
        default=0,
        metavar="MS",
        help="extra delay after each batch output (hydrabadger.rs:44)",
    )
    p.add_argument(
        "--start-epoch", type=int, default=0, help="era to start DHB at"
    )
    p.add_argument(
        "--engine",
        choices=["gpu", "cpu"],
        default="gpu",
        help="CryptoEngine backend (gpu: the card, raises without one)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="the gpu engine's torch device",
    )
    p.add_argument(
        "--rbc",
        choices=["bracha", "lowcomm"],
        default=None,
        help="reliable-broadcast variant (default: HYDRABADGER_RBC or "
        "bracha; consensus/broadcast.py)",
    )
    p.add_argument(
        "--fast-crypto",
        action="store_true",
        help="development tier: hash coin, no threshold encryption, "
        "no per-frame signatures",
    )
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--trace",
        default=None,
        metavar="PATH",
        help="record consensus spans (RBC/BA/subset/tdec/epoch) and dump "
        "on exit: .jsonl -> one event per line, anything else -> "
        "perfetto-loadable Chrome trace JSON",
    )
    p.add_argument(
        "--metrics",
        default=None,
        metavar="PATH",
        help="dump the node's metrics registry (queue depth/high-water "
        "gauges, per-kind wire counters, epoch histograms) as JSON on exit; "
        "a .jsonl path with --metrics-interval streams machine-readable "
        "fault/metrics summary lines instead (the process-tier "
        "supervisor's observability feed)",
    )
    p.add_argument(
        "--metrics-interval",
        type=float,
        default=0.0,
        metavar="S",
        help="with a .jsonl --metrics path: append one summary line "
        "(state, counters, gauge high-waters, fault-ring kinds) every S "
        "seconds plus a final line on exit; 0 = exit-only dump",
    )
    p.add_argument(
        "--checkpoint",
        default=None,
        metavar="PATH",
        help="durable generational checkpoint store: persist an "
        "era/epoch-stamped NodeCheckpoint here every --checkpoint-every "
        "committed epochs (+ a final one on graceful stop), and RESUME "
        "from it at boot when a loadable generation exists — the "
        "restart-from-disk path a supervisor uses after SIGKILL",
    )
    p.add_argument(
        "--checkpoint-every",
        type=int,
        default=1,
        metavar="N",
        help="committed epochs between durable checkpoints (default 1)",
    )
    p.add_argument(
        "--batch-log",
        default=None,
        metavar="PATH",
        help="append one JSONL line per committed batch (epoch, era, "
        "contribution digest, pk_set digest) — the cross-process "
        "agreement/identity feed the cluster supervisor asserts over",
    )
    p.add_argument(
        "--flight",
        nargs="?",
        const=FLIGHT_DEFAULT_DIR,
        default=None,
        metavar="DIR|PREFIX",
        help="mount the flight recorder (obs/flight.py): a bounded "
        "black box of recent spans/wire events + fault-ring mirror, "
        "dumped atomically (generational, digest-checked) on every "
        "fault-ring entry, a periodic heartbeat, and SIGTERM — the "
        "dump a SIGKILL cannot retract.  A directory (default tmp/obs) "
        "gets <uid>.flight.<pid>.json; anything else is used as the "
        "path prefix.  Implies an in-memory recorder even without "
        "--trace",
    )
    p.add_argument(
        "--mine",
        action="store_true",
        help="run the toy PoW blockchain demo and exit (peer_node.rs:81-92)",
    )
    return p


def gen_txns_factory(seed=None):
    rng = random.Random(seed)

    def gen_txns(count: int, nbytes: int) -> List[bytes]:
        return [
            bytes(rng.getrandbits(8) for _ in range(max(1, nbytes)))
            for _ in range(count)
        ]

    return gen_txns


def main(argv=None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.metrics_interval > 0 and not (
        args.metrics and args.metrics.endswith(".jsonl")
    ):
        parser.error(
            "--metrics-interval streams summary lines and needs a "
            ".jsonl --metrics path"
        )
    setup_logging()
    if args.mine:
        from . import blockchain

        chain = blockchain.mine(3)
        for block in chain.traverse():
            print(f"#{block.index} nonce={block.nonce} hash={block.hash}")
        return 0

    engine = named_engine(args.engine, args.device)
    cfg = Config(
        txn_gen_count=args.txn_gen_count,
        txn_gen_interval_ms=args.txn_gen_interval,
        txn_gen_bytes=args.txn_gen_bytes,
        keygen_peer_count=max(1, args.keygen_node_count - 1),
        output_extra_delay_ms=args.output_extra_delay,
        start_epoch=args.start_epoch,
        engine=engine,
        rbc_variant=args.rbc,
        checkpoint_path=args.checkpoint,
        checkpoint_every=max(1, args.checkpoint_every),
    )
    if args.fast_crypto:
        cfg.encrypt = False
        cfg.coin_mode = "hash"
        cfg.verify_shares = False
        cfg.wire_sign = False

    recorder = None
    if args.trace or args.flight:
        from .obs.recorder import DOMAIN_WALL, Recorder

        # the TCP node's stamping boundaries read the node wall clock
        # (declared domain; re-pointed at node.wall_now below so
        # injected skew is honestly visible in the trace)
        recorder = Recorder(clock_domain=DOMAIN_WALL)
        # warnings interleave with the spans they explain
        obs_logging.attach_recorder(recorder)

    host, port = args.bind_address
    node = None
    if args.checkpoint:
        # restart-from-disk: the generational store walks newest to
        # oldest, rejecting corrupt/truncated generations LOUDLY; only
        # when no generation loads does the node boot fresh (and then
        # re-joins through discovery/DKG like any newcomer)
        from .checkpoint import CheckpointStore

        ckpt = CheckpointStore(args.checkpoint).load()
        if ckpt is not None:
            node = Hydrabadger.from_checkpoint(
                InAddr(host, port), ckpt, cfg, seed=args.seed, recorder=recorder
            )
            print(
                f"resumed from checkpoint: era {ckpt.era} epoch "
                f"{ckpt.epoch} ({'validator' if ckpt.sk_share else 'observer'})",
                file=sys.stderr,
            )
    if node is None:
        node = Hydrabadger(InAddr(host, port), cfg, seed=args.seed, recorder=recorder)
    if recorder is not None:
        # emit_stamped consumers without their own clock (the logging
        # mirror) read the node's skewed wall clock too
        recorder.clock = node.wall_now
    if args.flight:
        import os as _os

        from .obs.flight import FlightRecorder

        uid8 = node.uid.bytes.hex()[:8]
        prefix = (
            _os.path.join(args.flight, f"{uid8}.flight")
            if args.flight.endswith(_os.sep) or _os.path.isdir(args.flight)
            or args.flight == FLIGHT_DEFAULT_DIR
            else args.flight
        )
        node.flight = FlightRecorder(
            prefix,
            node=uid8,
            recorder=recorder,
            metrics=node.metrics,
            fault_ring=node.fault_log,
            clock=node.wall_now,
            mono=node._now,  # skew reaches the dump debounce too
        )
    remotes = [OutAddr(h, p) for h, p in args.remote_address]

    stop_reason = {"why": "exit"}
    metrics_jsonl = (
        args.metrics if args.metrics and args.metrics.endswith(".jsonl")
        else None
    )

    def summary_line(final: bool) -> dict:
        """One machine-readable fault/metrics summary.  ``t`` is the
        NODE's wall clock (wall_now), ``t_host`` the honest host clock.
        The counters carry the process registry's too (the device
        batches of the wire-signature checks and the DKG plane's lanes),
        and ``launches`` this process's kernel launches so far, so a
        supervisor reads the device work of every incarnation."""
        import os as _os
        import time as _t

        from .obs.metrics import default_registry
        from .ops import fq_torch, gf256_torch

        snap = node.metrics.snapshot()
        counters = dict(default_registry().snapshot()["counters"])
        counters.update(snap["counters"])
        return {
            "t": node.wall_now(),
            "t_host": _t.time(),
            # counters reset when a replacement process reuses the same
            # file: readers separate incarnations by pid
            "pid": _os.getpid(),
            "node": node.uid.bytes.hex()[:8],
            "state": node.state,
            "final": final,
            "reason": stop_reason["why"] if final else None,
            "counters": counters,
            "gauges": {
                k: g["high_water"] for k, g in snap["gauges"].items()
            },
            "launches": {
                "fq_point": fq_torch.launches,
                "gf256_matmul": gf256_torch.launches,
            },
            "faults": [f.kind for _nid, f in node.fault_log],
            # per-span latency sketches, mergeable across nodes
            "sketches": node.txn_lifecycle.sketch_feed(),
        }

    def append_summary(final: bool = False) -> None:
        import json

        with open(metrics_jsonl, "a") as fh:
            fh.write(json.dumps(summary_line(final)) + "\n")
            fh.flush()

    async def run():
        import signal as _signal

        loop = asyncio.get_running_loop()
        # strong refs to the graceful-stop task: the loop only holds a
        # weak one, and a GC'd task is a silently-cancelled stop
        graceful_tasks = []

        def _graceful(why: str):
            # SIGTERM: drain async futures, persist a final checkpoint and
            # dump the flight recorder (all inside node.stop()), exit 0
            stop_reason["why"] = why
            graceful_tasks.append(asyncio.ensure_future(node.stop()))

        try:
            loop.add_signal_handler(
                _signal.SIGTERM, lambda: _graceful("sigterm")
            )
        except (NotImplementedError, RuntimeError):
            pass  # non-unix event loop: Ctrl-C/stop() remain

        async def log_batches():
            import hashlib
            import json
            import time as _t

            while True:
                batch = await node.batch_queue.get()
                print(
                    f"epoch {batch.epoch}: "
                    f"{len(batch.contributions)} contributions, "
                    f"{sum(len(bytes(v)) for v in batch.contributions.values())}B",
                    flush=True,
                )
                if args.batch_log:
                    h = hashlib.sha256()
                    for p, v in sorted(batch.contributions.items()):
                        h.update(bytes(p))
                        h.update(bytes(v))
                    # the pk_set digest is read from the LIVE core, so
                    # around an era cutover it may already be the next
                    # era's — tag it with the era it actually belongs
                    # to (pk_era), not the batch's, or cross-process
                    # agreement checks would compare different eras'
                    # keys under one label
                    pk_set = hashlib.sha256(
                        node.dhb.netinfo.pk_set.to_bytes()
                    ).hexdigest()[:16]
                    row = json.dumps({
                        # node wall clock: the committed-batch
                        # anchor the aggregator aligns clocks with;
                        # t_host is the honest host clock for
                        # supervisor-side gap bookkeeping
                        "t": node.wall_now(),
                        "t_host": _t.time(),
                        "epoch": batch.epoch,
                        "era": batch.era,
                        "digest": h.hexdigest(),
                        "pk_era": node.dhb.era,
                        "pk_set": pk_set,
                    })
                    # row built on the loop (consensus state must be
                    # read synchronously), disk append offloaded —
                    # awaited, so rows stay in commit order and the
                    # open/flush never stalls the wire pumps
                    await loop.run_in_executor(
                        None, _append_line, args.batch_log, row
                    )

        async def summary_loop():
            import json

            while True:
                await asyncio.sleep(args.metrics_interval)
                # snapshot on the loop (counters mutate under it), disk
                # append offloaded — awaited, so lines stay ordered and
                # the open/flush never stalls the wire pumps
                row = json.dumps(summary_line(False))
                await loop.run_in_executor(
                    None, _append_line, metrics_jsonl, row
                )

        async def flight_loop():
            # heartbeat dump: even a fault-free incarnation that takes a
            # SIGKILL leaves a black box at most one interval stale
            # (skipped while nothing new was recorded); its own task, so
            # the black box does not depend on --metrics being streamed
            interval = args.metrics_interval if args.metrics_interval > 0 else 1.0
            while True:
                await asyncio.sleep(interval)
                node.flight.maybe_dump("periodic")

        tasks = [asyncio.create_task(log_batches())]
        if metrics_jsonl and args.metrics_interval > 0:
            tasks.append(asyncio.create_task(summary_loop()))
        if node.flight is not None:
            tasks.append(asyncio.create_task(flight_loop()))
        gen = gen_txns_factory(args.seed)
        try:
            await node.run_node(
                remotes, lambda c, b: gen(min(c, args.batch_size), b)
            )
        finally:
            for t in tasks:
                t.cancel()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        stop_reason["why"] = "keyboard_interrupt"
    finally:
        if args.trace and recorder is not None:
            import os as _os

            from .obs import export as obs_export

            meta = {
                "clock_domain": recorder.clock_domain,
                "node": node.uid.bytes.hex()[:8],
                "pid": _os.getpid(),
            }
            if args.trace.endswith(".jsonl"):
                n = obs_export.write_jsonl(
                    recorder.events, args.trace, meta=meta
                )
            else:
                n = obs_export.write_chrome_trace(
                    recorder.events, args.trace, meta=meta
                )
            print(f"trace: {n} events -> {args.trace}", file=sys.stderr)
        if metrics_jsonl:
            append_summary(final=True)
            print(f"metrics stream -> {metrics_jsonl}", file=sys.stderr)
        elif args.metrics:
            import json

            from .obs.metrics import default_registry

            with open(args.metrics, "w") as fh:
                json.dump(
                    {
                        "node": node.metrics.snapshot(),
                        "process": default_registry().snapshot(),
                    },
                    fh,
                    indent=1,
                )
            print(f"metrics -> {args.metrics}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
