"""The port's message-lifecycle ledger against the JAX package's.

  * `ledger_update` on numpy-made observables, pass after pass, against
    the JAX function on the same inputs (vmapped over the ranks):
    without queues, and with D = 2 and 4 slots and a lag vector, with
    drops, integrity rejections and suppression, and under both seeded
    leaks; the counts and both queues exactly equal after every pass.
    The observables are consistent (each edge's census is its source
    rank's fired count), so `audit_window` is clean without a leak; its
    verdict, check count and named violations equal the JAX auditor's
    on the same snapshots, and each leak breaks a receiver-side law;
  * an unknown `EG_LEDGER_LEAK` raises where the step is built;
  * the conservation matrix of the JAX package's `test_conservation_
    matrix` (eventgrad / sp_eventgrad x dense / compact x staleness 0,
    1, 2 x the chaos + integrity axes), the composed overlap stack
    (D = 2, K = 4, compact, int8 carrier, a straggler) and the
    D-PSGD dense census, run through the port's `train(obs="epoch")` at
    the same op-point (MLP, Ring(4), 64 samples, batch 8): every flush
    window audits clean, the run totals balance integer-exactly, and the
    axes a leg does not run stay zero;
  * both leak oracles in process (`monkeypatch`): each one is caught,
    naming a law on `fired`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.obs import ledger as jax_ledger
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu_torch.chaos import inject
from eventgrad_tpu_torch.chaos.integrity import IntegrityConfig
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.obs import ledger
from eventgrad_tpu_torch.obs.schema import LEDGER_COUNTER_ROWS
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.steps import make_train_step

R, L, PASSES = 4, 6, 7
CHAOS_SPEC = "seed=7,drop=0.25,bitflip=0-24@0.3"
EVENT_CFG = EventConfig(adaptive=True, horizon=0.95, warmup_passes=2,
                        max_silence=4)


# --- ledger_update and audit_window against JAX ---------------------------


def _observables(rng, topo, depth):
    """One pass of consistent rank-stacked observables: the proposal,
    the suppress mask, the fire bits a subset of the kept proposal, each
    edge's census its source rank's fired count, drops, rejections and
    lags."""
    prop = rng.random((R, L)) < 0.6
    sup = rng.random((R, L)) < 0.2
    fire = prop & ~sup & (rng.random((R, L)) < 0.8)
    fired = fire.sum(-1).astype(np.int32)
    src = inject.host_source_table(topo)
    obs = {
        "prop_fire": prop, "suppress": sup, "fire_vec": fire,
        "n_msgs": fired[src].astype(np.int32),
        "deliver": rng.random((R, 2)) < 0.7,
        "oks": rng.random((R, 2)) < 0.8,
    }
    if depth:
        obs["lag_vec"] = rng.integers(1, depth + 2, (R, 2)).astype(np.int32)
    return obs


def _same_ledger(t, j, what):
    for f in ("counts", "queue", "late_queue"):
        tv, jv = getattr(t, f), getattr(j, f)
        assert (tv is None) == (jv is None), (what, f)
        if tv is not None:
            assert tv.dtype == torch.int32, (what, f)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=f"{what} {f}")


@pytest.mark.parametrize("depth,leak", [
    (0, ""), (2, ""), (4, ""), (2, "uncounted_drop"), (0, "double_reject"),
])
def test_ledger_update_and_audit_match_jax(depth, leak, monkeypatch):
    """Pass after pass the counts and queues are JAX's exactly; the audit
    of each window and of the run is JAX's verdict, and a leak breaks a
    law on `fired`."""
    if leak:
        monkeypatch.setenv(jax_ledger.LEAK_ENV, leak)
    rng = np.random.default_rng(11 + depth)
    topo, jtopo = Ring(R), JaxRing(R)
    tled = ledger.MessageLedger.init(2, depth, n_ranks=R)
    jled = jax.vmap(lambda _: jax_ledger.MessageLedger.init(
        2, queue_depth=depth))(jnp.arange(R))
    jup = jax.vmap(lambda led, o: jax_ledger.ledger_update(led, **o))
    t_prev = j_prev = None
    for p in range(PASSES):
        o = _observables(rng, topo, depth)
        tled = ledger.ledger_update(
            tled, leak_mode=leak,
            **{k: torch.from_numpy(v) for k, v in o.items()})
        jled = jup(jled, {k: jnp.asarray(v) for k, v in o.items()})
        _same_ledger(tled, jled, f"pass {p + 1}")
        if p in (2, PASSES - 1):
            t_a = ledger.audit_window(tled, t_prev, topo)
            j_a = jax_ledger.audit_window(jled, j_prev, jtopo)
            assert t_a == j_a
            assert t_a["checks"] > 0 and t_a["ok"] == (not leak), t_a
            if leak:
                assert any("fired" in v["law"] for v in t_a["violations"])
            assert (ledger.window_block(tled, t_prev)
                    == jax_ledger.window_block(jled, j_prev))
            t_prev, j_prev = tled, jled
    np.testing.assert_array_equal(tled.in_flight().numpy(),
                                  np.asarray(jax.vmap(
                                      lambda led: led.in_flight())(jled)))


def test_leak_env_rejects_unknown_value(monkeypatch):
    monkeypatch.setenv(ledger.LEAK_ENV, "bogus_leak")
    model = MLP(hidden=8, input_shape=(8, 8, 1), device="cpu")
    with pytest.raises(ValueError, match="EG_LEDGER_LEAK"):
        make_train_step(model, Ring(R), "eventgrad", EVENT_CFG,
                        fused_sgd=(0.1, 0.0), obs=True)
    # the variable is read only when telemetry is on
    make_train_step(model, Ring(R), "eventgrad", EVENT_CFG,
                    fused_sgd=(0.1, 0.0))


# --- the conservation matrix through train() ------------------------------


def _run(algo="eventgrad", wire="dense", staleness=0, chaos=None,
         integrity=None, epochs=2, **kw):
    x, y = synthetic_dataset(64, (8, 8, 1), seed=1)
    kw.setdefault("event_cfg", EVENT_CFG)
    if wire == "compact" and algo == "eventgrad":
        kw.setdefault("compact_frac", 0.5)
    return train(
        MLP(hidden=8, input_shape=(8, 8, 1), device="cpu"), Ring(R), x, y,
        algo=algo, epochs=epochs, batch_size=8, learning_rate=0.1,
        obs="epoch", seed=0, staleness=staleness, gossip_wire=wire,
        chaos=chaos, integrity=integrity, log_every_epoch=False,
        device="cpu", **kw)


def _blocks(history):
    out = [h["obs"] for h in history
           if "obs" in h and "message_ledger" in h["obs"]]
    assert len(out) == len(history)
    return out


def _totals(blocks):
    tot = {k: 0 for k in LEDGER_COUNTER_ROWS}
    for b in blocks:
        for k in tot:
            tot[k] += sum(b["message_ledger"][k])
    tot["in_flight"] = sum(blocks[-1]["message_ledger"]["in_flight"])
    return tot


def _assert_conserved(tot, *, chaos_on, staleness):
    assert tot["proposed"] == (
        tot["suppressed"] + tot["deferred"] + tot["fired"]), tot
    assert tot["fired"] == (
        tot["delivered"] + tot["dropped"] + tot["rejected"]
        + tot["in_flight"]), tot
    assert tot["late_committed"] <= tot["delivered"], tot
    assert tot["proposed"] > 0 and tot["delivered"] > 0, tot
    if not chaos_on:
        assert tot["dropped"] == 0 and tot["rejected"] == 0, tot
    if staleness < 2:
        assert tot["in_flight"] == 0 and tot["late_committed"] == 0, tot


def _assert_clean(blocks):
    for b in blocks:
        assert b["ledger_audit"]["ok"], b["ledger_audit"]["violations"]
        assert b["ledger_audit"]["checks"] > 0


MATRIX = [
    # (algo, wire, staleness, chaos_on, integrity_on): the JAX matrix
    ("eventgrad", "dense", 0, False, False),
    ("eventgrad", "dense", 1, True, True),
    ("eventgrad", "dense", 2, False, False),
    ("eventgrad", "compact", 0, False, False),
    ("eventgrad", "compact", 2, True, True),
    ("sp_eventgrad", "dense", 0, False, False),
    ("sp_eventgrad", "compact", 1, False, False),
    ("sp_eventgrad", "dense", 2, False, False),
]


@pytest.mark.parametrize("algo,wire,staleness,chaos_on,integrity_on",
                         MATRIX)
def test_conservation_matrix(algo, wire, staleness, chaos_on,
                             integrity_on):
    chaos = ChaosSchedule.parse(CHAOS_SPEC) if chaos_on else None
    integrity = (IntegrityConfig(checksum=True, quarantine=True)
                 if integrity_on else None)
    _, hist = _run(algo=algo, wire=wire, staleness=staleness, chaos=chaos,
                   integrity=integrity)
    blocks = _blocks(hist)
    _assert_clean(blocks)
    _assert_conserved(_totals(blocks), chaos_on=chaos_on,
                      staleness=staleness)


def test_conservation_composed_overlap_stack():
    """D = 2, K = 4 tails, compact at half capacity, the int8 carrier and
    a straggler: clean, balanced, with real late commits. The JAX test
    adds drop=0.25; the port's bucketed schedule under drops waits
    (ROADMAP queue 1, item 12) and refuses, so this leg runs the
    straggler alone."""
    x, y = synthetic_dataset(64, (8, 8, 1), seed=1)
    _, hist = train(
        MLP(hidden=8, input_shape=(8, 8, 1), device="cpu"), Ring(R), x, y,
        algo="eventgrad", epochs=3, batch_size=8, learning_rate=0.1,
        obs="epoch", seed=0, staleness=2, gossip_wire="compact",
        compact_frac=0.5, wire="int8", bucketed=4, carrier_resident=True,
        chaos=ChaosSchedule.parse("seed=7,slow=1@3"), event_cfg=EVENT_CFG,
        log_every_epoch=False, device="cpu")
    blocks = _blocks(hist)
    _assert_clean(blocks)
    tot = _totals(blocks)
    _assert_conserved(tot, chaos_on=False, staleness=2)
    assert tot["late_committed"] > 0, tot


def test_conservation_dpsgd_dense_census():
    """D-PSGD ships every leaf every pass: fired = delivered + dropped =
    L x passes x ranks per edge, and the drops land."""
    _, hist = _run(algo="dpsgd", chaos=ChaosSchedule.parse("seed=5,drop=0.3"))
    blocks = _blocks(hist)
    _assert_clean(blocks)
    tot = _totals(blocks)
    assert tot["proposed"] == tot["fired"]
    assert tot["suppressed"] == 0 and tot["deferred"] == 0
    assert tot["dropped"] > 0
    passes = sum(h["steps"] for h in hist)
    for b, h in zip(blocks, hist):
        assert b["message_ledger"]["fired"] == [4 * h["steps"] * R] * 2
    assert tot["fired"] == 4 * passes * R * 2
    _assert_conserved(tot, chaos_on=True, staleness=0)


@pytest.mark.parametrize("leak", ledger.LEAKS)
def test_leak_oracles_break_a_law_by_name(leak, monkeypatch):
    """The seeded leak, armed in process before the step is built, breaks
    a receiver-side law, and the auditor names it."""
    monkeypatch.setenv(ledger.LEAK_ENV, leak)
    _, hist = _run(chaos=ChaosSchedule.parse(CHAOS_SPEC),
                   integrity=IntegrityConfig(checksum=True, quarantine=True))
    bad = [b["ledger_audit"] for b in _blocks(hist)
           if not b["ledger_audit"]["ok"]]
    assert bad, f"leak {leak!r} slipped past the auditor"
    laws = {v["law"] for a in bad for v in a["violations"]}
    assert any("fired" in law for law in laws), laws


def test_ledger_audit_op_point_passes_its_gates():
    """`utils/ledger_audit.py` at the JAX tool's op-point: every gate of
    the record (0 violations, every disposition exercised, both leaks
    caught naming a law, obs off bitwise the ledgered run), and the
    committed `artifacts/torch_ledger_conservation_cpu.json` is such a
    record of the same op-point as the JAX artifact's."""
    import json
    import pathlib

    from eventgrad_tpu_torch.utils import ledger_audit

    rec = ledger_audit.run(device="cpu")
    assert ledger_audit.ok(rec), {k: rec[k] for k in (
        "conservation", "dispositions_exercised", "leak_oracles")}
    root = pathlib.Path(__file__).resolve().parent.parent / "artifacts"
    mine = json.loads((root / "torch_ledger_conservation_cpu.json")
                      .read_text())
    theirs = json.loads((root / "ledger_conservation_cpu.json").read_text())
    assert ledger_audit.ok(mine)
    for key in ("op_point", "chaos", "integrity", "topo", "algo"):
        assert mine[key] == theirs[key] == rec[key], key
