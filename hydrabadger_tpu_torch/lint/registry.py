"""The sanitizer / source / secret registry the dataflow passes consult.

The port's copy of hydrabadger_tpu/lint/registry.py, aimed at
hydrabadger_tpu_torch/.  Everything the interprocedural passes treat as
special is DECLARED here rather than hard-coded in the analysis — the
registry is the auditable contract surface: adding a new wire-decode
entry point or a new secret-bearing class is a one-line diff that the
reviewer sees next to the code it blesses.  Every key names a file of
the port (``relpath::qualname[::expr]`` relative to the port's package
root); the port keeps the JAX package's file layout, so most keys read
as theirs do.

Two registries:

* **attacker-taint** (`lint/taint.py`): where adversary-controlled data
  enters (``TAINT_SOURCE_CALLS`` / ``TAINT_SOURCE_ATTRS`` /
  ``TAINT_SOURCE_PARAMS``) and which operations launder it
  (``CLAMP_FUNCS`` — value clamps; structural ``len()``-guard
  recognition lives in lint/dataflow.py).
* **secret-taint** (`lint/secrets.py`): which names/classes carry key
  material (``SECRET_NAME_TOKENS`` / ``SECRET_CLASSES``) and which
  calls consume it legitimately (``SECRET_SEAL_FUNCS``).

Tables of the JAX registry with no counterpart here, because the rules
that read them check JAX and Mosaic code the port does not have (the
``mosaic``, ``jit-hygiene`` and ``retrace-budget`` rules, and their
runtime twin ``obs/retrace.py``, are not ported):

* ``SHAPE_BUCKET_FUNCS`` / ``BUCKET_CAPACITY`` / ``SANITIZING_FUNCS`` —
  the ``_bucket`` lane ladder that bounds jit signature sets; the port
  launches its kernels at the caller's exact lane count (no bucketing,
  so no retrace to bound), and attacker-taint's jit-entry sink, which
  these tables sanitize, has no counterpart either;
* ``CONFIG_BOUNDED_JIT`` and the modules' ``RETRACE_BUDGETS`` — the
  declared signature budgets of ``@jax.jit`` entry points; the port has
  no jit entry points.
"""
from __future__ import annotations

# --------------------------------------------------------------------------
# attacker-taint sources
# --------------------------------------------------------------------------

# Calls whose RETURN VALUE is attacker-controlled, matched on the dotted
# call name's suffix (``codec.decode`` matches ``codec.decode(...)`` and
# ``utils.codec.decode(...)``).
TAINT_SOURCE_CALLS = frozenset(
    {
        "codec.decode",
        "WireMessage.decode",
    }
)

# Methods whose return value is attacker-controlled wherever the
# receiver object came from (resolved by bare method name — these names
# are unique to the wire/router planes).
TAINT_SOURCE_METHODS = frozenset(
    {
        "recv",  # WireStream.recv: (message, body, signature) off a socket
    }
)

# Attribute reads that yield attacker-controlled data regardless of the
# base object's taint (a WireMessage's payload is raw decoded bytes even
# when the message variable itself is untracked).
TAINT_SOURCE_ATTRS = frozenset({"payload", "enc_rows", "enc_values", "commit_bytes"})

# Parameters seeded tainted: (relpath, function name, parameter).
# These are the entry points where wire/router deliveries surface as
# plain arguments — the seeds the interprocedural fixpoint grows from.
TAINT_SOURCE_PARAMS = frozenset(
    {
        ("sim/router.py", "_enqueue", "message"),
        # Byzantine scenario plane: the fault-injection hook sees every
        # routed frame, and a ByzantineNode's inbound deliveries are the
        # raw material its strategies replay/corrupt — both are
        # adversary-controlled end to end
        ("sim/scenario.py", "inject", "message"),
        ("sim/byzantine.py", "handle_message", "message"),
        ("sim/byzantine.py", "on_receive", "message"),
        ("net/node.py", "_on_net_state", "net_state"),
        ("net/node.py", "_on_join_plan", "payload"),
        ("net/node.py", "_on_era_transcript", "payload"),
        ("net/node.py", "_on_key_gen_message", "payload"),
        ("net/node.py", "_on_consensus_message", "payload"),
        ("net/node.py", "_discover", "peers_info"),
        # the codec parses raw frames: its buffer is the attack surface
        ("utils/codec.py", "_py_decode", "buf"),
        ("utils/codec.py", "_decode_at", "buf"),
        ("utils/codec.py", "_read_uvarint", "buf"),
    }
)

# Value clamps: a call to one of these with at least one clean argument
# yields a clean (bounded) value.
CLAMP_FUNCS = frozenset({"min", "max"})

# --------------------------------------------------------------------------
# attacker-taint sinks — scoping
# --------------------------------------------------------------------------

# Unbounded-container-growth findings are scoped to the io planes where
# raw attacker bytes land; consensus cores receive membership-gated,
# signature-checked traffic and their queues are epoch-bounded (pinned
# by the sim soak's flat-RSS assertion rather than by this pass).
GROWTH_SCOPE = ("net/", "sim/")

# Loop-bound/repetition sinks are scoped to the frame-PARSING planes:
# there a count comes straight out of attacker bytes (a varint, a list
# header).  Deeper planes (crypto/, ops/) receive structure-validated
# objects whose sizes the dkg/threshold layers pin (degree checks, row
# counts, shard counts) — their loop bounds track validated structure,
# not raw wire integers.
LOOP_BOUND_SCOPE = ("net/", "sim/", "utils/")

# --------------------------------------------------------------------------
# secret-taint
# --------------------------------------------------------------------------

# An identifier is secret-seeded when, split on underscores, it contains
# one of these tokens ("our_sk", "sk_share", "secret_key", "seckey"…).
SECRET_NAME_TOKENS = frozenset({"sk", "secret", "seckey"})

# Explicit identifier substrings that do not tokenise cleanly.
SECRET_NAMES = frozenset({"chan_key", "channel_key", "key_material"})

# Classes whose instances ARE key material: constructing, receiving or
# unpacking one taints the value; each must also define a redacting
# __repr__ (checked by the class-hygiene half of the pass).
SECRET_CLASSES = frozenset({"SecretKey", "SecretKeyShare", "SecretKeySet"})

# Calls that legitimately consume secrets (sealing / KDF / signing /
# group-exponentiation primitives): a secret disappearing into one of
# these is the intended use, not an egress.  Matched on the dotted call
# name's last component.
SECRET_SEAL_FUNCS = frozenset(
    {
        "_seal",
        "_seal_batch",
        "_open",
        "_keystream_xor",
        "_kdf",
        "sha256",
        "sha",
        "digest",
        "new",
        "compare_digest",
        "_pair_digest",
        "mul_sub",
        "multiply",
        "fr_random",
        "pow",
        # one-way group maps: their output is public-key-grade
        "hash_to_g2",
        "interpolate_g_at_zero",
        "g1_to_bytes",
        "g2_to_bytes",
        # curve-point arithmetic: outputs are group elements, blinded by
        # the discrete log (the same rationale as mul_sub/multiply)
        "jac_add",
        "jac_double",
        "jac_add_core_formula",
        "jac_double_formula",
        "add",
        "eq",
    }
)

# Metadata reads that are safe on a secret-tainted base: the SIZE or
# TYPE of key material is not key material.
SECRET_SAFE_ATTRS = frozenset(
    {
        "shape",
        "ndim",
        "dtype",
        # a tensor's device ("cuda:0") is placement metadata in the same
        # sense as its shape and dtype
        "device",
        "size",
        "kind",
        "fault",
        "valid",
        "recorded",
    }
)
SECRET_SAFE_CALLS = frozenset({"len", "type", "isinstance", "id", "qsize"})

# Logger variable names: a call on one of these is a logging sink.
LOG_NAMES = frozenset({"log", "logger", "logging"})

# Obs emitter bindings (hbtrace recorders / bound views): a call on one
# of these is a logging sink too — trace events are exported to disk
# and loaded into viewers, so key material reaching an emitter
# (``self.obs.emit(..., sk)``) is exactly as bad as logging it.  Exact
# names cover ``recorder`` handles and the ``rec``/``_rec`` internals
# of obs/recorder.py; any binding whose name ENDS in ``obs`` (``obs``,
# ``eobs``, ``epoch_obs``, ``hb_obs`` — the bound-view idiom) matches
# via lint/secrets.py:_obs_binding.
OBS_EMIT_NAMES = frozenset({"recorder", "rec", "_rec"})
OBS_EMIT_SUFFIX = "obs"

# --------------------------------------------------------------------------
# async dispatch (hbasync) — eager-fetch rule (lint/async_fetch.py)
# --------------------------------------------------------------------------

# Registered fetch points: "relpath::function" -> why a submit_* result
# may materialize there.  Everywhere else in the rule's scope
# (crypto/dkg.py, crypto/threshold.py, consensus/), calling .result()
# on — or np.asarray/list()/.item()-ing — a submit_* result is a
# finding: eager materialization re-synchronizes the dispatch and
# silently throws the overlap architecture away.
ASYNC_FETCH_POINTS = {
    "crypto/dkg.py::g1_msm_batch": (
        "the synchronous spelling: submit + immediate fetch, for callers "
        "outside the overlap plane"
    ),
    "crypto/dkg.py::settle": (
        "the settle closures of handle_parts_submit / "
        "_verify_values_batch_submit — THE designed fetch boundary; "
        "callers hold them across host work and invoke in submission "
        "order"
    ),
}

# --------------------------------------------------------------------------
# hbrace — async-interference & clock-domain passes
# --------------------------------------------------------------------------

# await-interference (lint/await_interference.py): read-modify-write of
# shared node state spanning an await point, declared safe.  Key is
# "relpath::Class.method::attr" — the coroutine that performs the RMW
# and the attribute it straddles; the value is the justification a
# reviewer audits (why the write cannot be stale: a single-writer
# discipline, a CAS-style re-check the analysis cannot see, ...).  An
# entry naming a function that no longer exists is itself a finding.
AWAIT_RMW_GUARDS: dict = {}

# blocking-in-async (lint/blocking_async.py): calls that block the OS
# thread — on the asyncio event loop they stall EVERY node pump sharing
# it.  Matched on the dotted call name's suffix (alias-tolerant for the
# stdlib time/os/subprocess modules).
BLOCKING_CALLS = {
    "time.sleep": "thread sleep",
    "os.fsync": "disk flush",
    "os.fdatasync": "disk flush",
    "subprocess.run": "child-process wait",
    "subprocess.call": "child-process wait",
    "subprocess.check_call": "child-process wait",
    "subprocess.check_output": "child-process wait",
    "open": "synchronous file open",
}

# Declared executor-offload boundaries: functions that DO name a
# blocking call in their body but ship the work off the event loop (or
# run it only on a path that is not on the loop).  Traversal of the
# async-reachability BFS stops here; each entry carries the
# justification.  A stale entry (function gone) is a finding.
EXECUTOR_OFFLOAD_BOUNDARIES = {
    "net/node.py::Hydrabadger._persist_checkpoint": (
        "disk work (two fsyncs + rotation) runs on the default executor "
        "on the hot path; the inline sync=True branch runs only at "
        "graceful stop, after the wire pumps are being torn down"
    ),
    "obs/flight.py::FlightRecorder.dump": (
        "the payload is captured synchronously from live rings, then "
        "the fsync+rotate write is offloaded to the default executor "
        "when a loop is running; inline only at stop/SIGTERM and in "
        "loop-less harnesses"
    ),
}

# clock-domain (lint/clock_domain.py).  Every timestamp source is
# declared with its domain; arithmetic mixing two domains, skewed time
# feeding supervisor freshness checks, monotonic stamps persisted into
# checkpoints/flight dumps, and raw OS-clock reads inside net/+obs/
# that bypass the node seams are findings.
#
#   source                      domain        axis
#   time.time()                 wall          host epoch seconds
#   time.monotonic()            mono          host monotonic
#   time.perf_counter()         mono          host monotonic
#   loop.time()                 mono          host monotonic (asyncio)
#   Hydrabadger._now()          skewed-mono   node monotonic + injected
#                                             offset/drift
#   Hydrabadger.wall_now()      skewed-wall   node wall + injected skew
#   feed field "t"              skewed-wall   node-stamped feed rows
#   feed field "t_host"         wall          honest host stamp (r14)
CLOCK_SOURCE_DOMAINS = {
    "time.time": "wall",
    "time.monotonic": "mono",
    "time.perf_counter": "mono",
}

# Bare method names whose RETURN VALUE carries a declared domain
# wherever the receiver came from (the node clock seams).
CLOCK_METHOD_DOMAINS = {
    "_now": "skewed-mono",
    "wall_now": "skewed-wall",
}

# Summary/batch feed fields with a declared domain, tracked in the
# declared consumer modules (string-keyed subscripts and .get() reads).
CLOCK_FEED_FIELD_DOMAINS = {
    "t": "skewed-wall",
    "t_host": "wall",
}
CLOCK_FEED_CONSUMERS = ("net/cluster.py",)

# Cross-object attributes with a declared domain (set in one class,
# read in another — the per-function inference cannot see across).
CLOCK_ATTR_DOMAINS = {
    # stamped by the owning node's _now() at construction (net/node.py)
    # so the handshake-stall timer and the stamp share one domain
    "born": "skewed-mono",
    "_last_progress_t": "skewed-mono",
}

# Functions allowed to read raw OS clocks inside net/ + obs/: THE
# injection seams everything else must route through.
CLOCK_INJECTION_POINTS = {
    "net/node.py::Hydrabadger._now": (
        "the skewed monotonic seam: every node timer reads this"
    ),
    "net/node.py::Hydrabadger.wall_now": (
        "the skewed wall seam: every observability stamp reads this"
    ),
    "obs/recorder.py::domain_clock": (
        "the declared domain-reader factory (obs/recorder.py DOMAIN_*)"
    ),
}

# Whole modules that legitimately read HOST clocks in net/+obs/: the
# supervisor/harness tier observes child incarnations from outside and
# has no node seam to route through — its clocks are the honest truth
# the skewed feeds are corrected against.
HOST_CLOCK_MODULES = {
    "net/cluster.py": (
        "process supervisor: measures honest host time across child "
        "incarnations (restart/watchdog/health timers); the skew it "
        "injects into children must never reach its own rulers"
    ),
    "net/chaos.py": (
        "chaos harness: wall budgets, partition heal deadlines and "
        "recovery catch-up are measured on the honest host clock"
    ),
}

# Persistence payload builders: a mono/skewed-mono value in the payload
# is meaningless after a restart (monotonic clocks reset at boot).
CLOCK_PERSIST_FUNCS = {
    "obs/flight.py::FlightRecorder.black_box": (
        "the flight-dump payload read by the aggregator"
    ),
}

# Freshness/health deciders: skewed node time in a staleness decision
# makes a skewed-fast node's feed look eternally fresh.
CLOCK_FRESHNESS_FUNCS = {
    "net/cluster.py::ClusterSupervisor.health": (
        "supervisor feed-staleness report: compares against t_host"
    ),
}

# --------------------------------------------------------------------------
# environment flags (lint/env_flags.py)
# --------------------------------------------------------------------------

# Every HYDRABADGER_* environment variable the package reads, with a
# one-line owner description — the kill-switch/threshold inventory.  An
# unregistered read is a finding (rule ``env-flag``): a flag that
# appears in no inventory is exactly how a plane-disabling switch rots.
# tests/test_torch_lint.py additionally verifies each entry is LIVE (some
# package source still reads it), so stale entries can't accumulate.
ENV_FLAGS = {
    "HYDRABADGER_GPU_DKG": (
        "era-switch DKG crypto on the card (kernel B2): 1 forced, 0 off, "
        "unset = auto when the process already holds a CUDA context (crypto/dkg)"
    ),
    "HYDRABADGER_ASYNC": (
        "hbasync cross-poll deferral; 0 settles every future at its "
        "submission site (crypto/futures)"
    ),
    "HYDRABADGER_COALESCE": (
        "per-tick MSM coalescing across in-process nodes; the sim "
        "scopes it on (crypto/futures.MsmCoalescer)"
    ),
    "HYDRABADGER_SHADOW_DKG": (
        "kill-switch: 0 reverts shadow-DKG scheduling to the "
        "inline-at-commit legacy path; the cutover-marker protocol "
        "itself is unconditional (crypto/dkg, read by "
        "consensus/dynamic_honey_badger)"
    ),
    "HYDRABADGER_SHADOW_DKG_BUDGET": (
        "committed parts settled per epoch by the shadow drain "
        "(default 16; crypto/dkg)"
    ),
    "HYDRABADGER_SHADOW_STALL_EPOCHS": (
        "epochs without committed DKG progress before the stall fault "
        "fires (default 8; crypto/dkg)"
    ),
    "HYDRABADGER_RBC": (
        "reliable-broadcast variant default: bracha (Merkle branches, "
        "the reference protocol) or lowcomm (reduced-communication RBC "
        "with homomorphic-sketch commitments); explicit SimConfig/Config "
        "values win (utils/envflags)"
    ),
    "HYDRABADGER_NTT": (
        "0 pins the reference polynomial paths everywhere (NTT plane "
        "kill-switch; crypto/dkg, crypto/rs)"
    ),
    "HYDRABADGER_NTT_MIN_N": (
        "Fr multipoint/NTT routing floor, default 384 (crypto/dkg)"
    ),
    "HYDRABADGER_NTT_MIN_SHARDS": (
        "RS FFT routing floor, default 128 without native SIMD "
        "(crypto/rs, crypto/engine)"
    ),
    "HYDRABADGER_CKPT_KEY": (
        "checkpoint HMAC authentication key (checkpoint.py)"
    ),
    "HYDRABADGER_CLOCK_SKEW_S": (
        "process-tier chaos: constant offset (seconds) added to this "
        "node's replay/backoff/gap timer clock; injected per child by "
        "the cluster supervisor (net/node, net/cluster)"
    ),
    "HYDRABADGER_CLOCK_RATE": (
        "process-tier chaos: drift rate multiplier on this node's "
        "timer clock (1.0 = honest; 1.5 = timers run 50% fast, so "
        "replays/stall declarations fire early) (net/node, net/cluster)"
    ),
    "HYDRABADGER_LOG": "structured logging level/filter spec (obs/logging)",
    "HYDRABADGER_FLIGHT": (
        "0 disables flight-recorder dumps (the black-box ring keeps "
        "recording; the atomic generational dump on fault-ring entries "
        "/ heartbeat / SIGTERM is skipped) (obs/flight)"
    ),
    "HYDRABADGER_NO_NATIVE_BLS": (
        "1 disables the native BLS library (crypto/native_bls)"
    ),
    "HYDRABADGER_NO_NATIVE_ACS": (
        "set to disable the native C++ ACS engine (sim/native_acs)"
    ),
    "HYDRABADGER_WIN_CIRCUIT": (
        "0 disables the windowed decrypt circuit (ops/decrypt_torch)"
    ),
    "HYDRABADGER_DECRYPT_T": (
        "0 runs the tensor sim's decrypt plane on the generic engine "
        "path (sim/tensor)"
    ),
}

# --------------------------------------------------------------------------
# state lifecycle (lint/state_lifecycle.py — hbstate)
# --------------------------------------------------------------------------

# CI wall-time budget for one full analyzer run (``--timing`` gate).
# The analyzer is the pre-commit hot path: when a pass blows this up,
# profile it — do not silently raise the number.
LINT_TIME_BUDGET_S = 60.0

# Node-lifetime classes whose mutable container attributes must carry a
# declared lifecycle.  "relpath::ClassName", matching lint/callgraph
# class qualnames.
STATE_SCOPE_CLASSES = (
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger",
    "consensus/honey_badger.py::HoneyBadger",
    "consensus/queueing.py::QueueingHoneyBadger",
    "net/node.py::Hydrabadger",
    "sim/network.py::SimNetwork",
    "sim/router.py::Router",
    "crypto/dkg.py::SyncKeyGen",
    # the txn-latency plane: the plane that watches for leaks must be
    # provably flat itself — every ledger it keeps is audited too
    "obs/latency.py::LatencySketch",
    "obs/latency.py::TxnLifecycle",
    "obs/latency.py::SloTracker",
)

# Era-flip path entrypoints: a ``per_era`` attr must have a clear/replace
# reachable from one of these over the callgraph.
ERA_FLIP_ANCHORS = (
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger._switch_era",
    "net/node.py::Hydrabadger._on_batch",
)

# Epoch commit path entrypoints: a ``per_epoch`` attr must have a
# reset/eviction reachable from one of these.
EPOCH_COMMIT_ANCHORS = (
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger._on_batch",
    # the sim loop invokes drain_async via getattr after every epoch, so
    # the callgraph cannot resolve a call INTO it — anchor it directly
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger.drain_async",
    "consensus/honey_badger.py::HoneyBadger._progress",
    "consensus/honey_badger.py::HoneyBadger.apply_external_batch",
    "consensus/queueing.py::QueueingHoneyBadger.handle_message",
    "consensus/queueing.py::QueueingHoneyBadger.apply_external_batch",
    "net/node.py::Hydrabadger._on_batch",
    "sim/network.py::SimNetwork.run_epoch",
)

# "relpath::Class.attr" -> (lifecycle, arg).  Lifecycles: "per_epoch" /
# "per_era" (arg None), "bounded" (arg = the cap's name, documentary),
# "process_lifetime" (arg = mandatory justification).  The analyzer
# verifies each declaration against the code; obs/census.py snapshots
# len() of every declared container at runtime (state_census_* gauges).
STATE_LIFECYCLE = {
    # -- consensus/dynamic_honey_badger.py::DynamicHoneyBadger -------------
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger.future_msgs": (
        "bounded", "10_000 literal len() guard in handle_message"
    ),
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger.batches": (
        "process_lifetime",
        "app-facing batch ledger; consumers (sim soak trims, chain "
        "builders) own retention",
    ),
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger.votes": (
        "per_era", None
    ),
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger.pub_keys": (
        "per_era", None
    ),
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger.pending_kg": (
        "per_era", None
    ),
    "consensus/dynamic_honey_badger.py::"
    "DynamicHoneyBadger._deferred_faults": ("per_epoch", None),
    # -- consensus/honey_badger.py::HoneyBadger ----------------------------
    "consensus/honey_badger.py::HoneyBadger.has_input": ("per_epoch", None),
    "consensus/honey_badger.py::HoneyBadger.epochs": ("per_epoch", None),
    "consensus/honey_badger.py::HoneyBadger.deferred": ("per_epoch", None),
    # -- consensus/queueing.py::QueueingHoneyBadger ------------------------
    "consensus/queueing.py::QueueingHoneyBadger.queue": ("per_epoch", None),
    "consensus/queueing.py::QueueingHoneyBadger.batches": (
        "process_lifetime",
        "app-facing batch ledger; tests and callers read full history",
    ),
    # -- crypto/dkg.py::SyncKeyGen -----------------------------------------
    "crypto/dkg.py::SyncKeyGen._chan_keys": (
        "process_lifetime",
        "pairwise-channel key memo, <= one entry per roster member; the "
        "SyncKeyGen object itself is era-scoped (replaced on era flip)",
    ),
    "crypto/dkg.py::SyncKeyGen.parts": (
        "process_lifetime",
        "one _ProposalState per validator proposal, <= n entries; the "
        "SyncKeyGen object itself is era-scoped (replaced on era flip)",
    ),
    # -- net/node.py::Hydrabadger ------------------------------------------
    "net/node.py::Hydrabadger.epoch_listeners": (
        "process_lifetime",
        "public subscription API; one entry per register_epoch_listener "
        "caller, caller-paced",
    ),
    "net/node.py::Hydrabadger._tasks": (
        "process_lifetime",
        "one handle per long-lived service task; cancelled in stop()",
    ),
    "net/node.py::Hydrabadger.fault_log": (
        "bounded", "FAULT_RING_CAP deque(maxlen=) ring"
    ),
    "net/node.py::Hydrabadger._dialing": (
        "process_lifetime",
        "in-flight outgoing dial set, discarded on completion; <= one "
        "entry per known peer",
    ),
    "net/node.py::Hydrabadger._internal": (
        "bounded", "Queue(maxsize=) construction bound"
    ),
    "net/node.py::Hydrabadger._overflow_tasks": (
        "bounded", "1024 len() guard + done-callback discard"
    ),
    "net/node.py::Hydrabadger._pending_user": (
        "bounded", "deque(maxlen=4096)"
    ),
    "net/node.py::Hydrabadger._transcript_served": (
        "process_lifetime",
        "per-peer transcript rate-limit stamps; <= one entry per peer uid",
    ),
    "net/node.py::Hydrabadger._ff_claims": (
        "process_lifetime",
        "fast-forward frontier claims; <= one entry per peer uid",
    ),
    "net/node.py::Hydrabadger.keygen_outbox": (
        "bounded", "KEYGEN_OUTBOX_CAP len() guard; also reset each batch"
    ),
    "net/node.py::Hydrabadger.keygen_inbox": (
        "bounded", "KEYGEN_INBOX_CAP len() guard"
    ),
    "net/node.py::Hydrabadger._keygen_inbox_seen": (
        "process_lifetime",
        "dedup mirror of keygen_inbox: grows in lockstep under the same "
        "KEYGEN_INBOX_CAP branch (cap on the sibling container, invisible "
        "to the guard recognizer); reset when bootstrap keygen restarts",
    ),
    "net/node.py::Hydrabadger.user_key_gens": (
        "bounded", "MAX_USER_KEYGENS len() guard"
    ),
    "net/node.py::Hydrabadger.iom_queue": (
        "bounded", "IOM_QUEUE_CAP len() guard; drain-swapped each pump"
    ),
    "net/node.py::Hydrabadger._epoch_outbox": (
        "bounded", "deque(maxlen=EPOCH_OUTBOX_MAX)"
    ),
    "net/node.py::Hydrabadger.batches": (
        "process_lifetime",
        "app-facing batch ledger; consumers own retention",
    ),
    "net/node.py::Hydrabadger.batch_queue": (
        "process_lifetime",
        "public batch delivery queue, consumer-paced by design (same "
        "verdict as the hbtaint suppression on this attr)",
    ),
    "net/node.py::Hydrabadger._wire_retry": (
        "bounded", "WIRE_RETRY_MAX_QUEUE popleft trim"
    ),
    "net/node.py::Hydrabadger._retry_attempts": (
        "bounded", "WIRE_RETRY_MAX_QUEUE popitem(last=False) trim loop"
    ),
    # -- sim/network.py::SimNetwork ----------------------------------------
    "sim/network.py::SimNetwork._dup_seen": (
        "process_lifetime",
        "per-(sender,kind) dup-suppression LRU rings trimmed in place "
        "through a local alias (per = ...; per.popitem), a shape the "
        "len() guard recognizer cannot see; cap is DUP_LRU_CAP per ring",
    ),
    "sim/network.py::SimNetwork._steady_durations": (
        "bounded", "4096 len() guard"
    ),
    "sim/network.py::SimNetwork.epoch_durations": (
        "process_lifetime",
        "one float per simulated epoch; the percentile source for "
        "era-gap bounds and bench attribution",
    ),
    "sim/network.py::SimNetwork._slo_cursor": (
        "process_lifetime",
        "one consumed-samples cursor per node id; keys mirror "
        "self.lifecycles (fixed topology), values are ints",
    ),
    # -- obs/latency.py (the txn-latency plane) ----------------------------
    "obs/latency.py::LatencySketch.buckets": (
        "bounded",
        "max_buckets collapse-lowest trim loop in add() AND merge()",
    ),
    "obs/latency.py::TxnLifecycle.pending": (
        "bounded", "max_pending popitem(last=False) LRU trim in submit()"
    ),
    "obs/latency.py::TxnLifecycle._notes": (
        "bounded",
        "notes_cap len() admission guard; drain-swapped each stamp()",
    ),
    "obs/latency.py::TxnLifecycle.samples": (
        "bounded", "samples_cap len() admission guard"
    ),
    "obs/latency.py::TxnLifecycle.sketches": (
        "process_lifetime",
        "fixed keyset: one LatencySketch per SPANS entry, built whole "
        "in __init__; _finish feeds values (each bucket-bounded above), "
        "never inserts keys",
    ),
    "obs/latency.py::SloTracker._window": (
        "bounded", "deque(maxlen=spec.window) construction"
    ),
    # -- sim/router.py::Router ---------------------------------------------
    "sim/router.py::Router._size_cache": (
        "bounded", "SIZE_CACHE_CAP popitem trim"
    ),
    "sim/router.py::Router.outputs": (
        "process_lifetime",
        "test-facing per-sender output ledger; tests assert on full "
        "history",
    ),
    "sim/router.py::Router.faults": (
        "process_lifetime",
        "test-facing fault ledger; tests assert on full history",
    ),
    "sim/router.py::Router.bytes_rx_by_kind": (
        "bounded", "RX_KIND_CAP len() guard"
    ),
}

# --------------------------------------------------------------------------
# quorum arithmetic (lint/quorum.py — hbquorum)
# --------------------------------------------------------------------------

# Every comparison of a count against a fault-tolerance-parameter
# expression in consensus/, net/ and sim/ must be declared here.
#
#   "relpath::Qualname::<canonical satisfied-at bound>" -> (class, note)
#
# The key's bound is the count at which the comparison is SATISFIED,
# rendered canonically ("f+1", "2*f+1", "n-f", "t+1", "n-2*f", "n*n",
# ...); one key covers every same-bound comparison inside that function.
# Classes:
#
#   "existence"    f+1-class  — at least one honest witness among any
#                               f+1 distinct senders;
#   "intersection" 2f+1/n-f-class — any two such quorums intersect in
#                               an honest node;
#   "dkg_degree"   t+1-class  — t+1 shares determine a degree-t
#                               polynomial;
#   "marker"       the >f era-cutover marker quorum (arithmetically an
#                               existence bound, semantically a distinct
#                               protocol gate);
#   "custom"       deliberately non-canonical arithmetic — the note is a
#                               MANDATORY justification.
#
# For the canonical classes the note is optional documentation; the
# analyzer verifies the declared class against the actual arithmetic
# and comparison direction (symbolically, then reduced under n = 3f+1,
# t = f).  Stale keys are findings.
QUORUM_SITES = {
    # -- consensus/binary_agreement.py -------------------------------------
    "consensus/binary_agreement.py::BinaryAgreement._handle_bval::f+1": (
        "existence", "seen a bval an honest node sent: relay it"
    ),
    "consensus/binary_agreement.py::BinaryAgreement._handle_bval::2*f+1": (
        "intersection", "bin_values admission (Mostefaoui BV-broadcast)"
    ),
    "consensus/binary_agreement.py::BinaryAgreement._check_aux::n-f": (
        "intersection",
        "n-f rendering: wait for all correct nodes' Aux votes",
    ),
    "consensus/binary_agreement.py::BinaryAgreement._check_conf::n-f": (
        "intersection",
        "n-f rendering: wait for all correct nodes' Conf votes",
    ),
    "consensus/binary_agreement.py::BinaryAgreement._handle_term::f+1": (
        "existence", "f+1 Term carries at least one honest decision"
    ),
    # -- consensus/broadcast.py --------------------------------------------
    "consensus/broadcast.py::Broadcast._handle_echo::n-f": (
        "intersection", "n-f rendering: Ready once all correct echoed"
    ),
    "consensus/broadcast.py::Broadcast._handle_echo::2*f+1": (
        "intersection", None
    ),
    "consensus/broadcast.py::Broadcast._handle_echo::n-2*f": (
        "existence",
        "k = data_shards = n - 2f erasure shards; reduces to f+1",
    ),
    "consensus/broadcast.py::Broadcast._handle_ready::f+1": (
        "existence", "Ready amplification (Bracha)"
    ),
    "consensus/broadcast.py::Broadcast._handle_ready::2*f+1": (
        "intersection", None
    ),
    "consensus/broadcast.py::Broadcast._handle_ready::n-2*f": (
        "existence",
        "k = data_shards = n - 2f erasure shards; reduces to f+1",
    ),
    "consensus/broadcast.py::Broadcast._handle_echo_lc::n-f": (
        "intersection", "n-f rendering: Ready once all correct echoed"
    ),
    "consensus/broadcast.py::Broadcast._handle_echo_lc::2*f+1": (
        "intersection", None
    ),
    "consensus/broadcast.py::Broadcast._handle_echo_lc::n-2*f": (
        "existence",
        "k = data_shards = n - 2f erasure shards; reduces to f+1",
    ),
    "consensus/broadcast.py::Broadcast._handle_ready_lc::f+1": (
        "existence", "Ready amplification (Bracha)"
    ),
    "consensus/broadcast.py::Broadcast._handle_ready_lc::2*f+1": (
        "intersection", None
    ),
    "consensus/broadcast.py::Broadcast._handle_ready_lc::n-2*f": (
        "existence",
        "k = data_shards = n - 2f erasure shards; reduces to f+1",
    ),
    "consensus/broadcast.py::Broadcast._try_decode_lc::n-2*f": (
        "existence",
        "k = data_shards candidates needed before erasure decode",
    ),
    # -- consensus/dynamic_honey_badger.py ---------------------------------
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger._on_batch::"
    "n*n+2*n+1": (
        "custom",
        "keygen flood cap n(n+2): own Part plus one ack per peer per "
        "batch with retransmits bounds every legitimate backlog",
    ),
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger._keygen_ready::"
    "f+1": (
        "dkg_degree",
        "t+1 complete proposals, t derived from the NEW era's roster "
        "((len(new_ids)-1)//3), so the bound renders in f-space",
    ),
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger."
    "_winning_change::2*count>n": (
        "custom",
        "strict majority of distinct committed votes picks the winning "
        "change; majority (not 2f+1) is the hbbft vote rule",
    ),
    "consensus/dynamic_honey_badger.py::DynamicHoneyBadger."
    "_cutover_committed::f+1": (
        "marker",
        ">f committed cutover markers: at least one from an honest "
        "node that truly finished its shadow settlement",
    ),
    "consensus/dynamic_honey_badger.py::_RemovedTracker.handle_part::n": (
        "custom", "structural arity: one encrypted row per member"
    ),
    "consensus/dynamic_honey_badger.py::_RemovedTracker.handle_ack::n": (
        "custom", "structural arity: one encrypted value per member"
    ),
    "consensus/dynamic_honey_badger.py::_RemovedTracker._complete::2*t+1": (
        "intersection",
        "2t+1 structural acks — the same objective gate as "
        "_ProposalState.is_complete, so leaver and validators agree",
    ),
    # -- consensus/subset.py -----------------------------------------------
    "consensus/subset.py::Subset._global_transitions::n-f": (
        "intersection",
        "n-f rendering: n-f accepted slots before voting 0 elsewhere",
    ),
    "consensus/subset.py::Subset._global_transitions::n": (
        "custom", "completion needs ALL n ABA instances decided"
    ),
    # -- consensus/threshold_*.py ------------------------------------------
    "consensus/threshold_decrypt.py::ThresholdDecrypt._try_decrypt::t+1": (
        "dkg_degree", None
    ),
    "consensus/threshold_sign.py::ThresholdSign._try_combine::t+1": (
        "dkg_degree", None
    ),
    # -- net/node.py -------------------------------------------------------
    "net/node.py::KeyGenMachine.handle_ack::n*n": (
        "custom",
        "pending-ack dedup ceiling: n senders x n proposer slots is "
        "the whole key space; reaching it means the invariant broke",
    ),
    "net/node.py::KeyGenMachine.is_complete::n": (
        "custom",
        "bootstrap all-n gate (key_gen.rs:373-386): every member's "
        "proposal complete before generate",
    ),
    "net/node.py::KeyGenMachine.is_complete::n*n": (
        "custom",
        "bootstrap n^2 ack gate (key_gen.rs:373-386): every member "
        "acked every proposal",
    ),
    "net/node.py::Hydrabadger._certified_frontier::f+1": (
        "existence",
        "f+1 signed frontier claims agree: at least one honest, so "
        "the (f+1)-th largest epoch is honestly certified",
    ),
    "net/node.py::Hydrabadger._on_era_transcript::2*n*n+2*n+1": (
        "custom",
        "transcript replay cap 2(n + n^2): n Parts + n^2 acks + "
        "batch-boundary markers bounded by traffic-bearing batches",
    ),
}

# --------------------------------------------------------------------------
# contract drift (lint/contract_drift.py — hbquorum)
# --------------------------------------------------------------------------

# The fault-observability registries, innermost tier first.  Each entry
# is (relpath, module-level dict name); later tiers may copy earlier
# ones (dict(BASE) + .update / subscript-assign), and the analyzer
# re-evaluates that construction statically.
CONTRACT_TIERS = (
    ("sim/scenario.py", "FAULT_OBSERVABLES"),
    ("net/chaos.py", "WIRE_FAULT_OBSERVABLES"),
    ("net/cluster.py", "PROC_FAULT_OBSERVABLES"),
)

# Where metric names are declared and where the BYZ_* taxonomy lives
# (fixture packages repoint these via monkeypatch).
CONTRACT_METRICS_MODULE = "obs/metrics.py"
CONTRACT_TAXONOMY_MODULE = "consensus/types.py"

# Exclusive-attribution escape hatch: fault-emit strings that two
# registry families deliberately share at equal match length, with the
# justification mirrored from sim/scenario.py's runtime attribution
# rules.  substring -> (sorted kinds tuple, why).
CONTRACT_SHARED_SUBSTRINGS = {
    "threshold_decrypt: conflicting share": (
        ("garbage_share", "replay_flood"),
        "a replayed decryption share and an attacker-minted conflicting "
        "share are the SAME wire evidence (two different shares under "
        "one (sender, proposer) key); scenario._attribute resolves the "
        "tie toward the kind the run actually injected, which is "
        "exactly the intent",
    ),
}

# Metric-minting wrapper functions: a call to one of these mints the
# counter/gauge named by the given argument, and the wrapper's own
# internal dynamic ``.counter(name)`` call is exempt.
#   "relpath::Class.method" -> (positional index, keyword name)
METRIC_MINT_WRAPPERS = {
    # fault-ring entry + optional detection counter in one call
    "net/node.py::Hydrabadger._note_fault": (1, "counter"),
    # checkpoint store bookkeeping (store is metrics-optional)
    "checkpoint.py::CheckpointStore._count": (0, "name"),
    # held-frame delivery whose failure mints the loss counter
    "net/chaos.py::ChaosWireStream._send_after": (2, "lost_kind"),
}

# Call sites that mint metric names dynamically (folding snapshots,
# prefix families, injection bookkeeping).  Keyed by the enclosing
# function; the value lists the names/prefixes the site can mint (for
# the declared-but-never-minted check) plus a mandatory justification.
#   "relpath::Qualname" -> (names tuple | None, why)
METRIC_DYNAMIC_MINTS = {
    "sim/scenario.py::verify_observability": (
        None,
        "reads the DECLARED observables back out of the registry "
        "(counter/gauge get-or-create on names that came from "
        "FAULT_OBSERVABLES entries this pass already checks)",
    ),
    "net/chaos.py::merge_node_metrics": (
        None,
        "folds per-node registry snapshots into one; every name it "
        "re-mints was minted (and therefore checked) at its original "
        "site",
    ),
    "net/cluster.py::ClusterSupervisor.merged_metrics": (
        None,
        "folds child-process summary lines into one registry; every "
        "name originated in a child's own checked mint site",
    ),
}
