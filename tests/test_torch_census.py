"""The port's state census (hydrabadger_tpu_torch/obs/census.py) against the
JAX package's: tests/test_obs.py's census cases on the port, the port's
lifecycle table (read from the port's lint registry) pinned equal to the
JAX lint registry's STATE_LIFECYCLE,
every declared attribute found on a live port object, and the port sim's
census rows equal to the JAX sim's, row for row, for 4-node qhb over 2
epochs and 4-node dhb through a removal era switch.
"""
import pytest

from hydrabadger_tpu.lint import registry
from hydrabadger_tpu_torch.lint import registry as port_registry
from hydrabadger_tpu.sim.network import SimConfig as JSimConfig
from hydrabadger_tpu.sim.network import SimNetwork as JSimNetwork
from hydrabadger_tpu_torch import checkpoint as ckpt
from hydrabadger_tpu_torch.obs import census
from hydrabadger_tpu_torch.obs.metrics import STATE_CENSUS_PREFIX, MetricsRegistry
from hydrabadger_tpu_torch.sim.network import SimConfig, SimNetwork


def test_census_take_folds_and_gauges(monkeypatch):
    """take() snapshots declared containers by class name, sample() folds
    with max across objects and emits state_census_* gauges."""

    class FakeCore:
        def __init__(self, n):
            self.ledger = list(range(n))
            self.undeclared = [1, 2, 3]

    monkeypatch.setattr(census, "_TABLE", {"FakeCore": {"ledger": ("per_era", None)}})
    assert census.take(FakeCore(4)) == {"FakeCore.ledger": 4}
    assert census.take(object()) == {}  # unknown classes are silent
    metrics = MetricsRegistry()
    sc = census.StateCensus(metrics=metrics)
    folded = sc.sample([FakeCore(2), FakeCore(7)], label=0)
    assert folded == {"FakeCore.ledger": 7}  # worst node wins
    snap = metrics.snapshot()
    assert snap["gauges"]["state_census_FakeCore.ledger"]["value"] == 7
    assert sc.latest() == {"FakeCore.ledger": 7}
    assert census.GAUGE_PREFIX == STATE_CENSUS_PREFIX == "state_census_"
    assert census.HISTORY_CAP == 4096 and sc.history.maxlen == 4096


def test_census_flatness_scoped_lifecycles_only(monkeypatch):
    """per_epoch/per_era growth beyond both slacks is flagged; bounded and
    process_lifetime keys are exempt, and jitter within the slack is not."""
    monkeypatch.setattr(census, "_TABLE", {"Core": {
        "votes": ("per_era", None), "epochs": ("per_epoch", None),
        "ring": ("bounded", "4096"), "batches": ("process_lifetime", "archive")}})
    baseline = {"Core.votes": 4, "Core.epochs": 2, "Core.ring": 10, "Core.batches": 10}
    later = {"Core.votes": 400, "Core.epochs": 10, "Core.ring": 4096, "Core.batches": 9000}
    assert census.flatness_violations(baseline, later) == ["Core.votes: 4 -> 400"]


def _declared(table) -> dict:
    """{"Class.attr": decl} of a lifecycle_table()."""
    return {f"{cls}.{attr}": decl for cls, attrs in table.items() for attr, decl in attrs.items()}


def test_census_table_equals_the_jax_registry():
    """The census reads the port's lint registry, whose STATE_LIFECYCLE is the
    JAX lint registry's, key for key (the port keeps the JAX file layout) and
    declaration for declaration; the census table is it reduced to
    "Class.attr", and lifecycle_of round-trips."""
    assert port_registry.STATE_LIFECYCLE == registry.STATE_LIFECYCLE
    theirs = {full.split("::", 1)[1]: decl for full, decl in registry.STATE_LIFECYCLE.items()}
    table = census.lifecycle_table()
    assert len(table) == 10
    assert _declared(table) == theirs
    for cls_attr, decl in theirs.items():
        assert census.lifecycle_of(cls_attr) == decl[0]


def _vote_out_last(net) -> None:
    for nid in net.ids[:-1]:
        net.router.dispatch_step(nid, net.nodes[nid].vote_to_remove(net.ids[-1]))


def test_every_declared_attribute_lives_on_a_port_object():
    """Each "Class.attr" names a sized container on a live port instance."""
    from hydrabadger_tpu_torch.net.node import Config, Hydrabadger
    from hydrabadger_tpu_torch.obs.latency import LatencySketch, SloSpec
    from hydrabadger_tpu_torch.utils.ids import InAddr

    objs = {}

    def keep(*found):
        for obj in found:
            objs.setdefault(type(obj).__name__, obj)

    qhb = SimNetwork(SimConfig(n_nodes=4, epochs=1, engine="cpu", seed=3,
                               slo=SloSpec(percentile=0.99, threshold_s=5.0, min_samples=8)))
    qhb.run()
    node = qhb.nodes[qhb.ids[0]]
    keep(qhb, qhb.router, node, node.hb, qhb.slo_tracker, *qhb.lifecycles.values(),
         LatencySketch())
    dhb = SimNetwork(SimConfig(n_nodes=4, protocol="dhb", engine="cpu", seed=3))
    _vote_out_last(dhb)
    for _ in range(4):
        dhb.run(1)
        for nid in dhb.ids:
            keep(*census.node_objects(dhb.nodes[nid]))
    keep(Hydrabadger(InAddr("127.0.0.1", 15749), Config(engine="cpu"), seed=1))
    assert set(census.lifecycle_table()) <= set(objs), sorted(objs)
    for cls_attr in _declared(census.lifecycle_table()):
        cls_name, attr = cls_attr.split(".", 1)
        assert hasattr(objs[cls_name], attr), cls_attr
        assert census._size(getattr(objs[cls_name], attr)) is not None, cls_attr


@pytest.mark.parametrize("protocol,epochs", [("qhb", 2), ("dhb", 4)])
def test_census_rows_equal_the_jax_sim(protocol, epochs):
    """The port sim samples the census every epoch, and each row equals the
    JAX sim's at the same seed (dhb: through a removal era switch)."""
    kw = dict(n_nodes=4, protocol=protocol, txns_per_node_per_epoch=2, txn_bytes=2, seed=3)
    ours = SimNetwork(SimConfig(engine="cpu", native_acs=False, **kw))
    theirs = JSimNetwork(JSimConfig(engine="cpu", native_acs=False, **kw))
    if protocol == "dhb":
        _vote_out_last(ours)
        _vote_out_last(theirs)
    m = ours.run(epochs)
    theirs.run(epochs)
    assert m.agreement_ok and len(ours.census.history) == epochs
    assert list(ours.census.history) == list(theirs.census.history)
    if protocol == "dhb":
        assert all(ours.nodes[nid].era > 0 for nid in ours.ids[:-1])
        assert any(k.startswith("DynamicHoneyBadger.") for k in ours.census.latest())
    gauges = {k: g for k, g in ours.metrics.snapshot()["gauges"].items()
              if k.startswith(STATE_CENSUS_PREFIX)}
    their_gauges = {k: g for k, g in theirs.metrics.snapshot()["gauges"].items()
                    if k.startswith(STATE_CENSUS_PREFIX)}
    assert gauges == their_gauges and len(gauges) >= 17


def test_census_rides_a_resumed_sim():
    """A sim snapshot carries its census: the resumed sim keeps its rows and
    samples on; sim_to_bytes accepts it (it holds no tensor)."""
    sim = SimNetwork(SimConfig(n_nodes=4, engine="cpu", seed=5))
    sim.run(2)
    resumed = ckpt.sim_from_bytes(ckpt.sim_to_bytes(sim))
    assert list(resumed.census.history) == list(sim.census.history)
    resumed.run(1)
    sim.run(1)
    assert len(resumed.census.history) == 3
    assert list(resumed.census.history) == list(sim.census.history)
