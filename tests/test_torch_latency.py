"""The port's transaction-latency plane (obs/latency.py) against the JAX
package's.

JAX tests/test_latency.py case for case on the port: the sketch's error
bound on adversarial distributions, the merge algebra, bounded memory under
10^6 inserts (one case that feeds the same values to both packages'
sketches), skew offsets cancelling and drift rates undone before a merge,
lifecycle hygiene, the SLO burn rate and the sketch-backed histogram.
Across the packages, on numpy-seeded samples: `add` (through the collapse
of a full sketch), `merge`, `scale`, `from_dict`, `merge_sketch_dicts`,
`exact_quantile`, the SLO verdicts and a 4-node sim's `exact_e2e_samples`.
"""
import math
import random

import numpy as np
import pytest

from hydrabadger_tpu.obs import latency as jlat
from hydrabadger_tpu_torch.obs.latency import (
    DEFAULT_MAX_BUCKETS,
    LatencySketch,
    SloSpec,
    SloTracker,
    TxnLifecycle,
    exact_quantile,
    merge_sketch_dicts,
    txn_id,
)

pytestmark = pytest.mark.slo

QS = (0.5, 0.9, 0.99, 0.999)


def _assert_within_rel_err(samples, sketch, slack=1.5):
    """Every quantile within the sketch's relative error (x slack: the
    clamping and the nearest-rank convention can add part of a bucket)."""
    for q in QS:
        approx = sketch.quantile(q)
        truth = exact_quantile(samples, q)
        assert truth is not None and approx is not None
        if truth <= 1e-9:
            assert approx <= 1e-9
            continue
        err = abs(approx - truth) / truth
        assert err <= sketch.rel_err * slack, f"q={q}: sketch {approx} vs exact {truth} ({err:.2%})"


def _sketch_of(values, cls=LatencySketch, **kw):
    sk = cls(**kw)
    for v in values:
        sk.add(v)
    return sk


def _state(sk):
    return (sk.buckets, sk.count, sk.zero_count, sk.sum, sk.min, sk.max)


# -- the error bound on adversarial distributions ----------------------------


def test_sketch_error_bound_heavy_tail():
    rng = random.Random(1)
    samples = [rng.lognormvariate(0.0, 2.0) for _ in range(100_000)]
    _assert_within_rel_err(samples, _sketch_of(samples))


def test_sketch_error_bound_bimodal_clusters():
    rng = random.Random(2)
    samples = [rng.gauss(1e-4, 1e-6) for _ in range(5000)]
    samples += [rng.gauss(10.0, 0.1) for _ in range(5000)]
    samples = [abs(v) for v in samples]
    _assert_within_rel_err(samples, _sketch_of(samples))


def test_sketch_error_bound_geometric_sweep():
    samples = [1e-6 * 1.01 ** i for i in range(2780)]
    _assert_within_rel_err(samples, _sketch_of(samples))


def test_sketch_error_bound_duplicates_and_zeros():
    samples = [0.0] * 100 + [0.25] * 900
    sk = _sketch_of(samples)
    assert sk.quantile(0.05) == 0.0  # the zero bucket ranks first
    _assert_within_rel_err(samples, sk)


# -- merge algebra ------------------------------------------------------------


def test_merge_commutative_and_associative():
    rng = random.Random(3)
    parts = [[rng.expovariate(1.0 / 0.2) for _ in range(2000)] for _ in range(3)]
    a_bc = _sketch_of(parts[0])
    bc = _sketch_of(parts[1])
    bc.merge(_sketch_of(parts[2]))
    a_bc.merge(bc)
    ab_c = _sketch_of(parts[0])
    ab_c.merge(_sketch_of(parts[1]))
    ab_c.merge(_sketch_of(parts[2]))
    c_ba = _sketch_of(parts[2])
    c_ba.merge(_sketch_of(parts[1]))
    c_ba.merge(_sketch_of(parts[0]))
    for other in (ab_c, c_ba):
        assert a_bc.buckets == other.buckets
        assert a_bc.count == other.count
        assert a_bc.zero_count == other.zero_count
        assert math.isclose(a_bc.sum, other.sum, rel_tol=1e-12)
        assert a_bc.min == other.min and a_bc.max == other.max


def test_merge_equals_whole_stream():
    rng = random.Random(4)
    xs = [rng.lognormvariate(-2.0, 1.0) for _ in range(3000)]
    ys = [rng.lognormvariate(1.0, 0.5) for _ in range(3000)]
    merged = _sketch_of(xs)
    merged.merge(_sketch_of(ys))
    whole = _sketch_of(xs + ys)
    assert merged.buckets == whole.buckets
    assert merged.count == whole.count
    _assert_within_rel_err(xs + ys, merged)


def test_merge_rejects_mismatched_rel_err():
    with pytest.raises(ValueError):
        LatencySketch(rel_err=0.01).merge(LatencySketch(rel_err=0.02))


# -- edges --------------------------------------------------------------------


def test_empty_sketch():
    sk = LatencySketch()
    assert sk.quantile(0.5) is None
    assert sk.percentiles() == {"p50": None, "p90": None, "p99": None, "p999": None}
    back = LatencySketch.from_dict(sk.to_dict())
    assert back.count == 0 and back.quantile(0.99) is None


def test_single_sample_exact():
    sk = LatencySketch()
    sk.add(0.317)
    for q in QS:
        assert sk.quantile(q) == pytest.approx(0.317)


def test_roundtrip_preserves_quantiles():
    rng = random.Random(5)
    sk = _sketch_of([rng.expovariate(2.0) for _ in range(1000)])
    back = LatencySketch.from_dict(sk.to_dict())
    for q in QS:
        assert back.quantile(q) == pytest.approx(sk.quantile(q))
    assert back.buckets == sk.buckets


# -- bounded memory -----------------------------------------------------------


def test_bounded_memory_under_1e6_inserts():
    """A million inserts across ~15 decades, fed to the port's default and
    tight (512-bucket) sketches and to the JAX package's default sketch:
    both stay bounded, the tight one keeps its tail, and the two packages'
    sketches hold the same buckets."""
    sk = LatencySketch()
    tight = LatencySketch(max_buckets=512)
    theirs = jlat.LatencySketch()
    rng = random.Random(6)
    samples = [rng.lognormvariate(0.0, 4.0) for _ in range(1_000_000)]
    for v in samples:
        sk.add(v)
        tight.add(v)
        theirs.add(v)
    assert len(sk.buckets) <= DEFAULT_MAX_BUCKETS
    assert len(tight.buckets) <= 512
    assert sk.count == tight.count == 1_000_000
    _assert_within_rel_err(samples, sk)
    truth = exact_quantile(samples, 0.999)
    assert abs(tight.quantile(0.999) - truth) / truth <= tight.rel_err * 1.5
    assert _state(sk) == _state(theirs)
    assert sk.percentiles() == theirs.percentiles()


# -- clock alignment ----------------------------------------------------------


def _lifecycle_run(clock, durations, cls=TxnLifecycle):
    """One submit -> admitted -> proposed -> committed cycle per duration,
    every boundary stamp read from `clock(t)`."""
    lc = cls()
    for i, d in enumerate(durations):
        tid = txn_id(b"txn-%d" % i)
        base = 100.0 + 10.0 * i
        assert lc.submit(tid, clock(base))
        lc.note_stage(tid, "admitted")
        lc.stamp(clock(base + 0.25 * d))
        lc.note_stage(tid, "proposed")
        lc.stamp(clock(base + 0.40 * d))
        lc.note_stage(tid, "committed")
        lc.stamp(clock(base + d))
    return lc


def test_skew_offset_cancels_in_latency():
    durations = [0.1 * (i + 1) for i in range(20)]
    honest = _lifecycle_run(lambda t: t, durations)
    skewed = _lifecycle_run(lambda t: t + 30.0, durations)
    assert skewed.sketches["e2e"].buckets == honest.sketches["e2e"].buckets
    for q in QS:
        assert skewed.sketches["e2e"].quantile(q) == pytest.approx(honest.sketches["e2e"].quantile(q))


def test_drift_rate_undone_by_aligned_merge():
    durations = [0.05 * (i + 1) for i in range(40)]
    honest = _lifecycle_run(lambda t: t, durations)
    drifted = _lifecycle_run(lambda t: 30.0 + t * 1.25, durations)
    raw = drifted.sketches["e2e"].quantile(0.5)
    assert raw == pytest.approx(1.25 * honest.sketches["e2e"].quantile(0.5), rel=0.03)
    merged = merge_sketch_dicts([dict(drifted.sketch_feed(), node="2")], {"2": 1.25})
    for q in QS:
        assert merged["e2e"].quantile(q) == pytest.approx(honest.sketches["e2e"].quantile(q), rel=0.03)


# -- lifecycle ledger hygiene -------------------------------------------------


def test_resubmission_dedup_does_not_restamp():
    lc = TxnLifecycle()
    tid = txn_id(b"dup")
    assert lc.submit(tid, 1.0)
    assert not lc.submit(tid, 5.0)  # dedup: the original stamp survives
    assert lc.resubmitted == 1
    lc.note_stage(tid, "committed")
    lc.stamp(9.0)
    assert lc.sketches["e2e"].quantile(0.5) == pytest.approx(8.0)


def test_pending_lru_bounded():
    lc = TxnLifecycle(max_pending=8)
    for i in range(32):
        lc.submit(txn_id(b"p%d" % i), float(i))
    assert len(lc.pending) == 8
    assert lc.evicted_pending == 24


def test_foreign_commit_resolves_to_nothing():
    lc = TxnLifecycle()
    lc.note_stage(txn_id(b"not-mine"), "committed")
    assert lc.stamp(1.0) == 0
    assert lc.committed_count == 0


# -- SLO burn rate ------------------------------------------------------------


def test_slo_green_below_threshold():
    tr = SloTracker(SloSpec(percentile=0.99, threshold_s=1.0, min_samples=4))
    for _ in range(64):
        tr.observe(0.2)
    assert tr.check() is None
    assert tr.violations == 0


def test_slo_violation_fires_loudly():
    tr = SloTracker(SloSpec(percentile=0.99, threshold_s=0.1, min_samples=4))
    msg = None
    for _ in range(16):
        tr.observe(0.5)
        msg = tr.check() or msg
    assert msg is not None and msg.startswith("slo violation:")
    assert "burn rate" in msg
    assert tr.violations > 0


def test_slo_min_samples_gates_verdict():
    tr = SloTracker(SloSpec(threshold_s=0.1, min_samples=10))
    for _ in range(9):
        tr.observe(9.9)  # way over, but not enough evidence yet
        assert tr.check() is None


# -- the histogram's sketch-backed tail --------------------------------------


def test_histogram_sketch_backed_tail_is_real():
    from hydrabadger_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    h = reg.histogram("epoch_duration_s", edges=(0.1, 1.0, 60.0))
    for _ in range(95):
        h.observe(0.5)
    for _ in range(5):
        h.observe(80.0)  # beyond the last edge: the fixed buckets say ">60"
    p99 = h.quantile(0.99)
    assert p99 is not None and abs(p99 - 80.0) / 80.0 <= 0.02
    snap = reg.snapshot()["histograms"]["epoch_duration_s"]
    assert snap["counts"][-1] == 5 and snap["total"] == 100
    assert snap["p99"] == pytest.approx(p99, rel=1e-6)
    assert LatencySketch.from_dict(snap["sketch"]).count == 100


# -- parity with the JAX package ---------------------------------------------


def _np_samples(seed, n):
    rng = np.random.default_rng(seed)
    out = np.concatenate([rng.lognormal(-3.0, 2.5, n), np.zeros(n // 50), rng.uniform(0, 1e-10, n // 50)])
    rng.shuffle(out)
    return [float(v) for v in out]


@pytest.mark.parametrize("max_buckets", [8, 64, DEFAULT_MAX_BUCKETS])
def test_add_merge_scale_and_dicts_equal_the_jax_ones(max_buckets):
    """The same samples through both packages: add (the collapse of a full
    sketch included), merge, scale, to_dict/from_dict and the quantiles."""
    parts = [_np_samples(seed, 6000) for seed in (11, 12, 13)]
    ours = [_sketch_of(p, max_buckets=max_buckets) for p in parts]
    theirs = [_sketch_of(p, jlat.LatencySketch, max_buckets=max_buckets) for p in parts]
    for a, b in zip(ours, theirs):
        assert a.to_dict() == b.to_dict()
    ours[0].merge(ours[1])
    theirs[0].merge(theirs[1])
    ours[0].scale(0.8)
    theirs[0].scale(0.8)
    ours[0].merge(ours[2])
    theirs[0].merge(theirs[2])
    for p in parts[2][:500]:
        ours[0].add(p)
        theirs[0].add(p)
    assert ours[0].to_dict() == theirs[0].to_dict()
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ours[0].quantile(q) == theirs[0].quantile(q)
    d = theirs[0].to_dict()
    assert LatencySketch.from_dict(d).to_dict() == jlat.LatencySketch.from_dict(d).to_dict() == d
    assert exact_quantile(parts[0], 0.99) == jlat.exact_quantile(parts[0], 0.99)
    assert exact_quantile([], 0.5) is None and jlat.exact_quantile([], 0.5) is None


def test_merge_sketch_dicts_with_rates_equals_the_jax_fold():
    feeds = []
    for node, seed in (("a", 21), ("b", 22), ("c", 23)):
        lc = _lifecycle_run(lambda t: t, [abs(v) + 0.01 for v in _np_samples(seed, 60)])
        feeds.append(dict(lc.sketch_feed(), node=node))
    feeds.append({"e2e": feeds[0]["e2e"], "junk": 3})  # untagged, a non-sketch entry
    rates = {"a": 1.0, "b": 1.25, "c": 0.5}
    ours = merge_sketch_dicts(feeds, rates)
    theirs = jlat.merge_sketch_dicts(feeds, rates)
    assert sorted(ours) == sorted(theirs) == ["admission", "consensus", "e2e", "propose_wait"]
    for span in ours:
        assert ours[span].to_dict() == theirs[span].to_dict()


def test_slo_verdicts_equal_the_jax_trackers():
    rng = np.random.default_rng(31)
    lat = rng.exponential(0.2, 2000)
    spec = dict(percentile=0.95, threshold_s=0.5, window=128, min_samples=16)
    ours, theirs = SloTracker(SloSpec(**spec)), jlat.SloTracker(jlat.SloSpec(**spec))
    verdicts = []
    for v in lat:
        ours.observe(float(v))
        theirs.observe(float(v))
        verdicts.append((ours.check(), theirs.check(), ours.burn_rate(), theirs.burn_rate()))
    assert all(a == b and r == s for a, b, r, s in verdicts)
    assert ours.violations == theirs.violations > 0


def test_sim_exact_e2e_samples_equal_the_jax_count():
    from hydrabadger_tpu.sim import network as jnet
    from hydrabadger_tpu_torch.sim import network

    kw = dict(n_nodes=4, protocol="qhb", epochs=3, txns_per_node_per_epoch=5, txn_bytes=8, seed=13)
    net = network.SimNetwork(network.SimConfig(engine="cpu", native_acs=False, **kw))
    m = net.run()
    jsim = jnet.SimNetwork(jnet.SimConfig(engine="cpu", native_acs=False, **kw))
    jsim.run()
    assert m.agreement_ok
    exact = net.exact_e2e_samples()
    assert len(exact) == len(jsim.exact_e2e_samples()) == net.txn_latency_snapshot()["count"] > 0
    spans = net.span_sketches()
    for q in (0.5, 0.99):
        truth = exact_quantile(exact, q)
        assert abs(spans["e2e"].quantile(q) - truth) / truth <= 0.02
    assert [lc.e2e_percentiles() for lc in net.lifecycles.values()] == [
        lc.sketches["e2e"].percentiles() for lc in net.lifecycles.values()]
    net.shutdown()
