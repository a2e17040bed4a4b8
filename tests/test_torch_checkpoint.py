"""The port's snapshots and resume (`utils/checkpoint.py`,
`train/state.py`'s flat form, `train(checkpoint_dir=, resume=)`).

  * against JAX: a JAX EventGraD state at `tests/test_resume.py`'s
    op-point (MLP, Ring(4), epoch 2), carried into the port
    (`convert.py`), saved by the port and resumed to epoch 4, agrees with
    the JAX package's own resume: epochs [3, 4], the event counts equal,
    the parameters within rtol=1e-4, atol=1e-6 (float32 sums in another
    order); the three layout guards raise the JAX loop's messages, word
    for word, in both directions (the JAX loop driven to its guard by a
    stand-in snapshot);
  * the port against itself, bitwise: a run interrupted after epoch 2
    and resumed to epoch 4 is the uninterrupted run (every state tensor,
    the random stream's bytes, the records), for EventGraD f32, int8
    carrier-resident, bucketed=2, staleness=2, sparsified EventGraD and
    D-PSGD under a chaos schedule; a compact-wire resume restarts the
    capacity autotune, as the JAX loop does;
  * the snapshot's behaviour: the flat round trip of every field, the
    `.prev` fallback, a corrupt primary recovered loudly (both corrupt
    raises), no snapshot starts fresh, `restore_with_fill` fills only
    known-added fields, `RollingRetention` prunes to `keep`.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.loop import train as jax_train
from eventgrad_tpu.utils import checkpoint as jax_checkpoint
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.chaos.monitor import PeerHealth
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train import loop as loop_lib
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.utils import checkpoint

IN_SHAPE = (8, 8, 1)
CFG = dict(adaptive=True, horizon=0.9, warmup_passes=2, max_silence=4)


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_bitwise(a, b):
    fa, fb = state_lib.to_flat(a), state_lib.to_flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(_bytes(fa[k]), _bytes(fb[k])), k


def _port(ck=None, *, epochs, resume=False, **kw):
    x, y = synthetic_dataset(128, IN_SHAPE, seed=3)
    kw.setdefault("algo", "eventgrad")
    return train(MLP(hidden=8, input_shape=IN_SHAPE), Ring(4), x, y,
                 epochs=epochs, batch_size=8, learning_rate=0.05,
                 momentum=0.9, event_cfg=EventConfig(**CFG),
                 random_sampler=True, seed=5,
                 checkpoint_dir=None if ck is None else str(ck),
                 save_every=2, resume=resume, device="cpu", **kw)


# --- against JAX ------------------------------------------------------------


def _jax_run(ck, *, epochs, resume):
    """`tests/test_resume.py::_run`'s op-point."""
    x, y = jax_synthetic(256, (28, 28, 1), seed=4)
    cfg = JaxEventConfig(adaptive=True, horizon=0.9, warmup_passes=3)
    return jax_train(JaxMLP(), JaxRing(4), x, y, algo="eventgrad",
                     epochs=epochs, batch_size=16, learning_rate=0.05,
                     event_cfg=cfg, random_sampler=True, seed=7,
                     checkpoint_dir=str(ck), save_every=2, resume=resume)


def _port_arena(params, spec):
    if isinstance(params, dict) or hasattr(params, "items"):
        tp, _ = convert.params_from_jax(
            jax.tree.map(np.asarray, params), stacked=True)
        return spec.ravel(tp)
    return convert.arena_from_jax(np.asarray(params), spec)


def test_resume_from_carried_jax_state_matches_jax_resume(tmp_path):
    jck = tmp_path / "jax"
    js2, _ = _jax_run(jck, epochs=2, resume=False)
    js4, jh4 = _jax_run(jck, epochs=4, resume=True)
    assert [h["epoch"] for h in jh4] == [3, 4]

    model = MLP()
    spec = arena_spec(model)
    cfg = EventConfig(adaptive=True, horizon=0.9, warmup_passes=3)
    tmpl = init_train_state(model, (28, 28, 1), Ring(4), "eventgrad", cfg,
                            seed=7, device="cpu")
    carried = tmpl.replace(
        params=_port_arena(js2.params, spec),
        event=convert.event_state_from_jax(
            jax.tree.map(np.asarray, js2.event), spec),
        pass_num=int(np.asarray(js2.pass_num).reshape(-1)[0]))
    ck = tmp_path / "port"
    checkpoint.save(str(ck / "ckpt"),
                    *state_lib.payload(carried, 2, "eventgrad"))
    x, y = synthetic_dataset(256, (28, 28, 1), seed=4)
    ts4, th4 = train(model, Ring(4), x, y, algo="eventgrad", epochs=4,
                     batch_size=16, learning_rate=0.05, event_cfg=cfg,
                     random_sampler=True, seed=7, checkpoint_dir=str(ck),
                     save_every=2, resume=True, device="cpu")
    assert [h["epoch"] for h in th4] == [3, 4]
    np.testing.assert_array_equal(
        ts4.event.num_events.numpy(), np.asarray(js4.event.num_events))
    assert ts4.pass_num == int(np.asarray(js4.pass_num).reshape(-1)[0])
    np.testing.assert_allclose(ts4.params.numpy(),
                               _port_arena(js4.params, spec).numpy(),
                               rtol=1e-4, atol=1e-6)
    for rt, rj in zip(th4, jh4):
        assert rt["num_events"] == rj["num_events"]
        assert rt["loss"] == pytest.approx(rj["loss"], rel=1e-4)


#: the guard cases: (snapshot's port keywords, resuming run's keywords,
#: the JAX snapshot's stand-in leaves)
_GUARDS = {
    "depth-2-into-lockstep": (
        dict(staleness=2), {},
        {"state/event/pending/0/1/0": np.zeros(2, np.float32)}),
    "lockstep-into-depth-2": (
        {}, dict(staleness=2),
        {"state/event/bufs/0": np.zeros(2, np.float32)}),
    "int8-carrier-into-f32": (
        dict(wire="int8", carrier_resident=True), dict(wire="int8"),
        {"state/event/bufs/0": np.zeros(2, np.int8)}),
    "f32-into-int8-carrier": (
        dict(wire="int8"), dict(wire="int8", carrier_resident=True),
        {"state/event/bufs/0": np.zeros(2, np.float32)}),
    "bucketed-2-into-monolithic": (
        dict(bucketed=2), {},
        {"state/event/bufs/0/1": np.zeros(2, np.float32)}),
    "monolithic-into-bucketed-2": (
        {}, dict(bucketed=2),
        {"state/event/bufs/0": np.zeros(2, np.float32)}),
}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("case", list(_GUARDS))
def test_layout_guard_raises_the_jax_message(case, tmp_path, monkeypatch):
    snap_kw, run_kw, jax_leaves = _GUARDS[case]
    ck = tmp_path / "ck"
    _port(ck, epochs=1, **snap_kw)
    with pytest.raises(RuntimeError) as port_err:
        _port(ck, epochs=2, resume=True, **run_kw)
    # the JAX loop, driven to the same guard by a stand-in snapshot of
    # the same layout
    monkeypatch.setattr(jax_checkpoint, "latest", lambda p: p)
    monkeypatch.setattr(jax_checkpoint, "peek", lambda p: _nest(jax_leaves))
    x, y = jax_synthetic(64, IN_SHAPE, seed=3)
    with pytest.raises(RuntimeError) as jax_err:
        jax_train(JaxMLP(hidden=8), JaxRing(4), x, y, algo="eventgrad",
                  epochs=2, batch_size=8, event_cfg=JaxEventConfig(**CFG),
                  checkpoint_dir=str(tmp_path / "jax"), resume=True,
                  **run_kw)
    assert str(port_err.value) == str(jax_err.value)
    assert str(port_err.value).startswith("checkpoint restore failed with ")


# --- the port against itself ------------------------------------------------


_SELF = {
    "eventgrad-f32": {},
    "eventgrad-int8-carrier": dict(wire="int8", carrier_resident=True),
    "eventgrad-bucketed-2": dict(bucketed=2),
    "eventgrad-staleness-2": dict(staleness=2),
    "sp_eventgrad": dict(algo="sp_eventgrad", sparse_cfg=SparseConfig(10.0)),
    "dpsgd-chaos": dict(algo="dpsgd", chaos="drop=0.3,seed=2,die=3@6"),
}


@pytest.mark.parametrize("case", list(_SELF))
def test_interrupted_and_resumed_is_bitwise_uninterrupted(case, tmp_path):
    kw = _SELF[case]
    s_full, h_full = _port(epochs=4, **kw)
    ck = tmp_path / "ck"
    _port(ck, epochs=2, **kw)
    s_res, h_res = _port(ck, epochs=4, resume=True, **kw)
    assert [h["epoch"] for h in h_res] == [3, 4]
    _assert_bitwise(s_full, s_res)
    for a, b in zip(h_full[2:], h_res):
        for k in a:
            # the block indices restart on a resume, whose first block
            # is cold
            if k not in ("wall_s", "chaos", "dispatch_block",
                         "dispatch_cold"):
                assert a[k] == b[k], k


def test_compact_resume_restarts_the_capacity_autotune(tmp_path):
    """The snapshot holds no autotune state (the JAX snapshot holds
    none): the resumed compact run runs dense for its first epoch and
    switches again at the same capacity."""
    kw = dict(gossip_wire="compact", compact_frac=0.5)
    _, h_full = _port(epochs=4, **kw)
    ck = tmp_path / "ck"
    _port(ck, epochs=2, **kw)
    _, h_res = _port(ck, epochs=4, resume=True, **kw)
    assert [r["gossip_wire"] for r in h_full] == ["dense"] + ["compact"] * 3
    assert [r["gossip_wire"] for r in h_res] == ["dense", "compact"]
    assert h_res[1]["compact_capacity"] == h_full[-1]["compact_capacity"]
    assert h_res[1]["compact_autotuned"] is False


# --- the snapshot's behaviour -----------------------------------------------


def test_flat_round_trip_covers_every_field(tmp_path):
    model = MLP(hidden=8, input_shape=IN_SHAPE)
    topo = Ring(4)
    st = init_train_state(model, IN_SHAPE, topo, "eventgrad",
                          EventConfig(**CFG), seed=1, momentum=0.9,
                          resident_wire="int8", bucketed=2, staleness=2,
                          device="cpu")
    st = st.replace(chaos=PeerHealth.init(topo, "cpu"), pass_num=7)
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    st = st.replace(rng=gen)
    # distinct values in every tensor, so a crossed path shows
    flat = state_lib.to_flat(st)
    for i, (k, v) in enumerate(sorted(flat.items())):
        if k not in ("state/rng", "state/pass_num"):
            v.copy_(torch.full_like(v, i % 100 + 1))
    tensors, meta = state_lib.payload(st, 3, "eventgrad")
    assert meta["layout"] == {"algo": "eventgrad", "ranks": 4,
                              "n_params": arena_spec(model).n_total,
                              "resident_dtype": "int8",
                              "staleness_depth": 2, "buckets": 2}
    for part in ("params", "trace", "pass_num", "rng", "event/thres",
                 "event/bufs/1/0", "event/buf_scales/0/1",
                 "event/pending/1/1/4/0", "event/edge_clock",
                 "event/late_commits", "chaos/silence", "chaos/sync_req"):
        assert f"state/{part}" in tensors, part
    checkpoint.save(str(tmp_path / "ckpt"), tensors, meta)
    raw, got_meta = checkpoint.peek(str(tmp_path / "ckpt"))
    assert got_meta["epoch"] == 3 and got_meta["device"] == "cpu"
    fresh = init_train_state(model, IN_SHAPE, topo, "eventgrad",
                             EventConfig(**CFG), seed=9, momentum=0.9,
                             resident_wire="int8", bucketed=2, staleness=2,
                             device="cpu").replace(
        chaos=PeerHealth.init(topo, "cpu"))
    back = state_lib.from_flat(
        fresh, checkpoint.restore(raw, state_lib.to_flat(fresh)))
    _assert_bitwise(st, back)
    assert back.pass_num == 7
    assert torch.equal(torch.rand(4, generator=back.rng),
                       torch.rand(4, generator=gen))


def test_resume_falls_back_to_prev(tmp_path):
    s_full, _ = _port(epochs=4)
    ck = tmp_path / "ck"
    _port(ck, epochs=2)
    path = str(ck / "ckpt")
    os.rename(path, path + ".prev")  # a kill between demotion and promote
    assert checkpoint.latest(path) == os.path.abspath(path) + ".prev"
    s_res, h_res = _port(ck, epochs=4, resume=True)
    assert [h["epoch"] for h in h_res] == [3, 4]
    _assert_bitwise(s_full, s_res)


def test_corrupt_primary_recovers_from_prev_loudly(tmp_path):
    s_full, _ = _port(epochs=4)
    ck = tmp_path / "ck"
    _port(ck, epochs=2)
    path = str(ck / "ckpt")
    shutil.copytree(path, path + ".prev")
    with open(os.path.join(path, checkpoint.TENSORS), "r+b") as f:
        f.truncate(100)  # a torn write
    ck2 = tmp_path / "ck2"
    shutil.copytree(str(ck), str(ck2))
    with open(os.path.join(str(ck2), "ckpt.prev", checkpoint.MANIFEST),
              "w") as f:
        f.write("{")
    with pytest.raises(RuntimeError, match="both unreadable"):
        _port(ck2, epochs=4, resume=True)
    with pytest.warns(RuntimeWarning, match="RECOVERED"):
        s_res, h_res = _port(ck, epochs=4, resume=True)
    assert [h["epoch"] for h in h_res] == [3, 4]
    _assert_bitwise(s_full, s_res)
    assert os.path.exists(path + ".corrupt")
    with pytest.raises(RuntimeError, match="No .prev twin"):
        checkpoint.peek(path + ".corrupt")


def test_resume_without_snapshot_starts_fresh(tmp_path):
    s_fresh, _ = _port(epochs=2)
    s, hist = _port(tmp_path / "none", epochs=2, resume=True)
    assert [h["epoch"] for h in hist] == [1, 2]
    _assert_bitwise(s_fresh, s)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _port(epochs=2, resume=True)


@pytest.mark.parametrize("across", ["algo", "device"])
def test_resume_across_algo_or_device_raises(across, tmp_path):
    """A snapshot restores only into a run of its own algorithm, on the
    device type it was written on: never silently, never by accident."""
    ck = tmp_path / "ck"
    _port(ck, epochs=2)
    if across == "algo":
        with pytest.raises(RuntimeError, match="^checkpoint restore failed "
                           "with algo='dpsgd': this snapshot was written by "
                           "an algo='eventgrad' run"):
            _port(ck, epochs=3, resume=True, algo="dpsgd")
        return
    # the same snapshot as a card run would have written it
    path = os.path.join(str(ck), "ckpt", checkpoint.MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(manifest, device="cuda"), f)
    with pytest.raises(RuntimeError, match="^checkpoint restore failed on "
                       "device 'cpu': this snapshot was written on 'cuda'"):
        _port(ck, epochs=3, resume=True)


def test_restore_with_fill_fills_only_known_added_fields(tmp_path):
    ck = tmp_path / "ck"
    s2, _ = _port(ck, epochs=2)
    tensors, meta = state_lib.payload(s2, 2, "eventgrad")
    # a snapshot from before EventState.num_deferred: resumes, loudly,
    # with the field at its initial value
    old = {k: v for k, v in tensors.items() if k != "state/event/num_deferred"}
    checkpoint.save(str(ck / "ckpt"), old, meta)
    with pytest.warns(UserWarning, match="num_deferred"):
        s, hist = _port(ck, epochs=3, resume=True)
    assert [h["epoch"] for h in hist] == [3]
    # any other missing field is a real mismatch
    checkpoint.save(str(ck / "ckpt"),
                    {k: v for k, v in tensors.items()
                     if k != "state/event/thres"}, meta)
    with pytest.raises(ValueError, match="state/event/thres"):
        _port(ck, epochs=3, resume=True)
    assert loop_lib._known_added("state/event/num_deferred")
    assert not loop_lib._known_added("state/event/thres")
    # a leaf whose shape changed is no added field either
    fill, missing = checkpoint.restore_with_fill(old, state_lib.to_flat(s2))
    assert missing == ["state/event/num_deferred"]
    assert torch.equal(fill["state/event/num_deferred"],
                       s2.event.num_deferred)
    bad = dict(tensors, **{"state/params": tensors["state/params"][:2]})
    with pytest.raises(ValueError, match="state/params"):
        checkpoint.restore_with_fill(bad, state_lib.to_flat(s2))
    with pytest.raises(ValueError, match="lacks leaves"):
        checkpoint.restore(old, state_lib.to_flat(s2))


def test_rolling_retention_prunes_to_keep(tmp_path):
    ret = checkpoint.RollingRetention(str(tmp_path / "good"), keep=2)
    t = {"state/x": torch.arange(3.0)}
    for e in (2, 4, 6, 8):
        ret.save_good(e, t, {"epoch": e})
    assert [e for e, _ in ret.snapshots()] == [6, 8]
    assert ret.latest_good()[0] == 8
    os.makedirs(ret.path_for(10) + ".tmp")  # in flight: not committed
    assert [e for e, _ in ret.snapshots()] == [6, 8]
    with pytest.raises(ValueError, match="keep"):
        checkpoint.RollingRetention(str(tmp_path), keep=0)
    raw, meta = checkpoint.peek(ret.path_for(8))
    assert meta["epoch"] == 8 and torch.equal(raw["state/x"], t["state/x"])


def test_async_writer_saves_and_reraises(tmp_path):
    w = checkpoint.AsyncWriter()
    snap = checkpoint.host_snapshot({"state/x": torch.ones(4)})
    w.save(str(tmp_path / "a"), snap, {"epoch": 1})
    w.wait()
    assert checkpoint.peek(str(tmp_path / "a"))[1]["epoch"] == 1
    (tmp_path / "file").write_text("")  # a save under a file fails
    w.save(str(tmp_path / "file" / "b"), snap, {"epoch": 2})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        w.close()
