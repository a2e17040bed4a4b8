"""The port's event state machine against the JAX package's, bitwise.

Identical `[L]` norm sequences (made with numpy from a seed) go through
`propose_from_norms` + `commit` of both packages over warmup, adaptive
slope updates and max_silence fires; every state vector and the fire
bits must be equal bit for bit at every pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu_torch.parallel import events

L = 24
PASSES = 60


def _norm_walk(seed):
    """Per-leaf norms drifting at leaf-specific rates, so some leaves
    fire on drift, some only on the silence bound."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 20.0, L)
    rate = np.geomspace(1e-4, 5e-1, L)
    steps = rng.standard_normal((PASSES, L)) * rate
    return (base + np.cumsum(steps, axis=0)).astype(np.float32)


def _jax_state():
    z = jnp.zeros((L,), jnp.float32)
    return jax_events.EventState(
        thres=z, last_sent_norm=z, last_sent_iter=z,
        slopes=jnp.zeros((L, 2), jnp.float32), bufs=(),
        num_events=jnp.zeros((), jnp.int32),
        num_deferred=jnp.zeros((), jnp.int32),
    )


def _torch_state():
    z = torch.zeros((L,), dtype=torch.float32)
    return events.EventState(
        thres=z, last_sent_norm=z, last_sent_iter=z,
        slopes=torch.zeros((L, 2), dtype=torch.float32), bufs=(),
        num_events=torch.zeros((), dtype=torch.int32),
        num_deferred=torch.zeros((), dtype=torch.int32),
    )


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize(
    "cfg_kw",
    [
        dict(adaptive=True, horizon=1.05, warmup_passes=5, max_silence=9),
        dict(adaptive=True, horizon=0.95, warmup_passes=3, max_silence=0),
        dict(adaptive=False, constant=0.05, warmup_passes=4, max_silence=6),
    ],
    ids=["adaptive-guarded", "adaptive-decaying", "constant"],
)
def test_state_machine_bitwise(cfg_kw):
    norms = _norm_walk(sum(map(ord, str(cfg_kw))))
    jcfg = jax_events.EventConfig(**cfg_kw)
    tcfg = events.EventConfig(**cfg_kw)
    js, ts = _jax_state(), _torch_state()
    fired_post_warmup = silence_fires = 0
    for p in range(1, PASSES + 1):
        jp = jax_events.propose_from_norms(
            jnp.asarray(norms[p - 1]), js, jnp.int32(p), jcfg
        )
        tp = events.propose_from_norms(
            torch.from_numpy(norms[p - 1]), ts, p, tcfg
        )
        for f in ("fire_vec", "thres", "iter_diff", "value_diff",
                  "new_slopes"):
            np.testing.assert_array_equal(
                _bits(getattr(tp, f).numpy()), _bits(getattr(jp, f)),
                err_msg=f"pass {p} {f}",
            )
        js = jax_events.commit(js, jp, jp.fire_vec, jcfg, 2)
        ts = events.commit(ts, tp, tp.fire_vec, tcfg, 2)
        for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes",
                  "num_events", "num_deferred"):
            np.testing.assert_array_equal(
                _bits(getattr(ts, f).numpy()), _bits(getattr(js, f)),
                err_msg=f"pass {p} {f}",
            )
        if p >= tcfg.warmup_passes:
            fired = tp.fire_vec.numpy()
            fired_post_warmup += int(fired.sum())
            if tcfg.max_silence:
                silence_fires += int(
                    (fired & (tp.iter_diff.numpy() >= tcfg.max_silence)).sum()
                )
    # the walk exercises the trigger, not just warmup
    assert 0 < fired_post_warmup < L * (PASSES - tcfg.warmup_passes)
    if tcfg.max_silence:
        assert silence_fires > 0


def test_rank_stacked_state_matches_per_rank():
    """The same functions on an `[R, L]` state equal R separate runs."""
    cfg = events.EventConfig(horizon=1.05, warmup_passes=2, max_silence=5)
    walks = np.stack([_norm_walk(s) for s in range(3)], axis=1)  # [P, R, L]
    z = torch.zeros((3, L))
    stacked = events.EventState(
        thres=z, last_sent_norm=z, last_sent_iter=z,
        slopes=torch.zeros((3, L, 2)), bufs=(),
        num_events=torch.zeros((3,), dtype=torch.int32),
        num_deferred=torch.zeros((3,), dtype=torch.int32),
    )
    singles = [_torch_state() for _ in range(3)]
    for p in range(1, 20):
        prop = events.propose_from_norms(
            torch.from_numpy(walks[p - 1]), stacked, p, cfg
        )
        stacked = events.commit(stacked, prop, prop.fire_vec, cfg, 2)
        for r in range(3):
            pr = events.propose_from_norms(
                torch.from_numpy(walks[p - 1, r]), singles[r], p, cfg
            )
            singles[r] = events.commit(singles[r], pr, pr.fire_vec, cfg, 2)
    for r in range(3):
        for f in ("thres", "last_sent_norm", "slopes", "num_events"):
            np.testing.assert_array_equal(
                _bits(getattr(stacked, f)[r].numpy()),
                _bits(getattr(singles[r], f).numpy()),
            )
